"""`python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see run.py)."""

import sys

from portbench.run import main

sys.exit(main())
