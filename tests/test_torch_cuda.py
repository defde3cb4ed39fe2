"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain PyTorch versions on the card — FAST-9+NMS over a level
atlas and through the single-image entry points bit-exact, the pose LM
within 1e-4 with the same inliers (also with every row stereo), two
launches bit-identical — the per-level extractor with the kernel against
the same extractor with the plain version on the card, and the mono and
two-image extractors and the stereo frame function, card against CPU —
`pose_optimize` over a batch of problems (the dp step's sequences) as
one launch equal to one launch a problem — the BoW table scores
against their plain version (the same counts, scores within 1e-5, two
calls bit-identical) — and the captured step: the kernels' device launch counts (graph replays
included), `core.control`'s IF nodes against the eager helpers, and a
session's replayed frames against its eager frames, and the dp program's
replayed steps (`distributed/dp.py` `DPProgram`) against its eager steps,
bit for bit, with no synchronisation under
`set_sync_debug_mode("error")`.  They skip without
a card.  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch import config
from orb_slam2_tpu_torch.core import lie
from orb_slam2_tpu_torch.frontend import fast_cuda, pyramid
from orb_slam2_tpu_torch.place import bow_cuda, database
from orb_slam2_tpu_torch.place import vocab as place_vocab
from orb_slam2_tpu_torch.solvers import pose_lm_cuda, pose_opt

# the 8 pyramid levels of a 640x480 frame, the two shapes of
# tests/test_pallas.py (one not a multiple of the tile) and a tiny level
LEVELS = pyramid.level_shapes(480, 640, 8, 1.2)
SHAPES = LEVELS + [(96, 256), (70, 128), (7, 7)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fast_kernel_matches_plain_on_card(shape):
    """One level as a one-plane atlas: the kernel equals the plain
    version."""
    _card()
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    img = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).cuda()
    before = fast_cuda.device_counts()[0]
    kn, kr = fast_cuda.fast_nms_atlas(img[None], [shape])
    pn, pr = fast_cuda.fast_nms_atlas_plain(img[None], [shape])
    torch.cuda.synchronize()
    assert fast_cuda.device_counts()[0] == before + 1
    assert torch.equal(kn, pn) and torch.equal(kr, pr)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(376, 1241)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_single_image_fast_matches_plain_on_card(shape):
    """`fast_nms_raw` / `fast_nms` on a CUDA level: one launch each, equal
    bit for bit to `fast_nms_raw_plain` on the card."""
    _card()
    rng = np.random.RandomState(shape[0] + 7 * shape[1])
    img = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).cuda()
    before = fast_cuda.device_counts()[0]
    kn, kr = fast_cuda.fast_nms_raw(img)
    kn1 = fast_cuda.fast_nms(img)
    pn, pr = fast_cuda.fast_nms_raw_plain(img)
    torch.cuda.synchronize()
    assert fast_cuda.device_counts()[0] == before + 2
    assert kn.shape == kr.shape == tuple(shape)
    assert torch.equal(kn, pn) and torch.equal(kr, pr) and torch.equal(kn1, pn)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["bench", "kitti"])
def test_perlevel_extractor_kernel_matches_plain_on_card(preset):
    """The per-level extractor on the card with no device named: one FAST
    launch a level; every field of its Features equal to the same
    extractor with the plain FAST on the card (`use_kernel=False`, no
    launch) — the same ops on the same device, the FAST maps bit-exact.
    At the bench's 640x480 (1000 features) and the KITTI 00-02 preset's
    1241x376 (2000)."""
    _card()
    from orb_slam2_tpu_torch.frontend.extractor import \
        build_extractor_perlevel
    from orb_slam2_tpu_torch.io import synthetic
    cfg = config.SLAMConfig() if preset == "bench" else config.kitti_config()
    cam = cfg.camera
    img = torch.from_numpy(synthetic.generate(cam, n_frames=1, n_points=50,
                                              seed=0).images[0]).cuda()
    kern = build_extractor_perlevel(cfg.orb, cam.height, cam.width)
    plain = build_extractor_perlevel(cfg.orb, cam.height, cam.width, "cuda",
                                     use_kernel=False)
    before = fast_cuda.device_counts()[0]
    fk = kern(img)
    assert fast_cuda.device_counts()[0] == before + cfg.orb.n_levels
    fp = plain(img)
    torch.cuda.synchronize()
    assert fast_cuda.device_counts()[0] == before + cfg.orb.n_levels
    assert fk.uv.is_cuda and int(fk.valid.sum()) > 0.5 * cfg.orb.n_features
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,n_images", [(480, 640, 1), (240, 320, 1),
                                          (480, 640, 2), (376, 1241, 2),
                                          (480, 640, 4), (480, 640, 8)])
def test_fast_atlas_kernel_matches_plain_on_card(H, W, n_images):
    """All 8 levels of n_images images in one launch, bit-exact against the
    plain version level by level; seeded values also outside the levels,
    which neither may read.  376x1241 is the KITTI stereo pair: an odd
    width, no level a multiple of the tile; 4 and 8 images are the S-image
    atlases of the dp step (distributed/dp.py), 32 and 64 planes."""
    _card()
    levels = pyramid.level_shapes(H, W, 8, 1.2)
    rng = np.random.RandomState(H + n_images)
    atlas = torch.from_numpy((rng.rand(8 * n_images, H, W) * 255).astype(
        np.float32)).cuda()
    before = fast_cuda.device_counts()[0]
    kn, kr = fast_cuda.fast_nms_atlas(atlas, levels)
    pn, pr = fast_cuda.fast_nms_atlas_plain(atlas, levels)
    torch.cuda.synchronize()
    assert fast_cuda.device_counts()[0] == before + 1
    assert torch.equal(kn, pn) and torch.equal(kr, pr)


@pytest.mark.cuda
def test_extractor_on_card_matches_cpu():
    """One frame through the atlas extractor on the card (one kernel
    launch for all levels) and on the CPU (plain version): the same
    keypoint slots."""
    _card()
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    from orb_slam2_tpu_torch.io import synthetic
    cfg = config.SLAMConfig()
    img = synthetic.generate(cfg.camera, n_frames=1, n_points=50,
                             seed=0).images[0]
    before = fast_cuda.device_counts()[0]
    g = build_atlas_extractor(cfg.orb, 480, 640, "cuda")(
        torch.from_numpy(img).cuda())
    c = build_atlas_extractor(cfg.orb, 480, 640, "cpu")(torch.from_numpy(img))
    assert fast_cuda.device_counts()[0] == before + 1
    assert float(_same_slots(g, c).float().mean()) >= 0.99


def _stereo_pair(cfg):
    """Frame 0 of the bench sequence and its right eye, at cfg's camera."""
    from orb_slam2_tpu_torch.io import synthetic
    left = synthetic.generate(cfg.camera, n_frames=1, n_points=50, seed=0)
    right = synthetic.generate(
        cfg.camera, n_frames=1, n_points=4, seed=0,
        poses_override=synthetic.right_poses(left.poses_twc,
                                             cfg.camera.baseline))
    return torch.from_numpy(left.images[0]), torch.from_numpy(right.images[0])


def _same_slots(g, c):
    return ((g.valid.cpu() == c.valid) & (g.octave.cpu() == c.octave) &
            ((g.uv.cpu() - c.uv).abs().amax(-1) <= 1e-3))


@pytest.mark.cuda
def test_two_image_extractor_on_card_matches_cpu():
    """A 640x480 stereo pair through the two-image extractor: one kernel
    launch for all 16 planes on the card; per image the same keypoint
    slots as the CPU run, and the same raw atlas."""
    _card()
    from orb_slam2_tpu_torch.frontend.atlas import build_atlas_extractor
    cfg = config.SLAMConfig(sensor=config.STEREO,
                            camera=config.CameraConfig(bf=40.0))
    pair = torch.stack(_stereo_pair(cfg))
    before = fast_cuda.device_counts()[0]
    g, ga = build_atlas_extractor(cfg.orb, 480, 640, "cuda", n_images=2,
                                  return_atlas=True)(pair.cuda())
    c, ca = build_atlas_extractor(cfg.orb, 480, 640, "cpu", n_images=2,
                                  return_atlas=True)(pair)
    assert fast_cuda.device_counts()[0] == before + 1
    assert ga.shape == (16, 480, 640)
    assert float((ga.cpu() - ca).abs().max()) <= 1e-3
    for b in range(2):
        same = _same_slots(type(g)(*(a[b] for a in g)),
                           type(c)(*(a[b] for a in c)))
        assert float(same.float().mean()) >= 0.99, b


@pytest.mark.cuda
def test_stereo_frame_fn_on_card_matches_cpu():
    """The stereo frame function at the bench's stereo configuration, card
    against CPU, with the CPU tests' per-image tolerances: matched sets
    with Jaccard >= 0.98; ur within 1e-2 px and depth within 1e-3 m where
    both match on the same slot."""
    _card()
    from orb_slam2_tpu_torch.pipeline.frame import build_stereo_frame_fn
    cfg = config.SLAMConfig(sensor=config.STEREO,
                            camera=config.CameraConfig(bf=40.0))
    left, right = _stereo_pair(cfg)
    before = fast_cuda.device_counts()[0]
    g = build_stereo_frame_fn(cfg, "cuda")(left.cuda(), right.cuda(), 0, 0.0)
    c = build_stereo_frame_fn(cfg, "cpu")(left, right, 0, 0.0)
    assert fast_cuda.device_counts()[0] == before + 1
    same = (g.valid.cpu() == c.valid) & \
        ((g.uv_raw.cpu() - c.uv_raw).abs().amax(-1) <= 1e-3)
    assert float(same.float().mean()) >= 0.99
    gm, cm = g.ur.cpu() >= 0, c.ur >= 0
    assert int(cm.sum()) > 300
    assert int((gm & cm).sum()) / int((gm | cm).sum()) >= 0.98
    b = gm & cm & same
    assert float((g.ur.cpu() - c.ur)[b].abs().max()) <= 1e-2
    assert float((g.depth.cpu() - c.depth)[b].abs().max()) <= 1e-3


K4 = (500.0, 500.0, 320.0, 240.0)


def _pose_problem(seed, n, stereo_frac, bf=40.0):
    """A pose ~0.05 off the truth, half-pixel noise, 10% outliers, on the
    card: (T0, pw, uv, ur, inv_sigma2, valid, is_stereo, K, bf)."""
    rng = np.random.RandomState(seed)
    pw = (rng.randn(n, 3) * [2.0, 2.0, 0.8] + [0, 0, 5.0]).astype(np.float32)
    T_true = lie.se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.03, -0.02, 0.01]))
    pc = lie.se3_apply(T_true, torch.from_numpy(pw)).numpy()
    uv = (pc[:, :2] / pc[:, 2:] * K4[:2] + K4[2:] +
          rng.randn(n, 2) * 0.5).astype(np.float32)
    out = rng.rand(n) < 0.1
    uv[out] += (rng.randn(out.sum(), 2) * 30).astype(np.float32)
    is_st = rng.rand(n) < stereo_frac
    ur = np.where(is_st, uv[:, 0] - bf / pc[:, 2], -1.0).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 8, n)).astype(np.float32)
    T0 = lie.se3_compose(lie.se3_exp(torch.tensor(
        [0.05, 0.05, -0.05, 0.03, 0.02, -0.02])), T_true)
    arrs = [T0, torch.from_numpy(pw), torch.from_numpy(uv),
            torch.from_numpy(ur), torch.from_numpy(inv_s2),
            torch.from_numpy(rng.rand(n) < 0.97), torch.from_numpy(is_st),
            torch.tensor(K4)]
    return [a.cuda() for a in arrs] + [bf]


@pytest.mark.cuda
@pytest.mark.parametrize("n,stereo_frac", [(1024, 0.0), (1024, 1 / 3),
                                           (1024, 1.0), (64, 0.0),
                                           (8192, 0.0), (2048, 0.75)])
def test_pose_lm_kernel_matches_plain_on_card(n, stereo_frac):
    """Pose within 1e-4 (float32 sums in another order), inlier masks equal
    on >= 99% of points and counts within 2 (a chi^2 at its threshold may
    flip); `pose_optimize` on CUDA tensors launches the kernel once.
    N = 8192 is the most a launch takes (8 points a thread); stereo_frac
    1.0 makes every row stereo, as on the stereo path; N = 2048 is the
    KITTI preset's keypoint capacity."""
    _card()
    p = _pose_problem(n, n, stereo_frac)
    before = pose_lm_cuda.device_launches()
    k = pose_opt.pose_optimize(*p)
    r = pose_opt.pose_optimize_plain(*p)
    assert pose_lm_cuda.device_launches() == before + 1
    assert float((k.T - r.T).abs().max()) <= 1e-4
    assert float((k.inliers == r.inliers).float().mean()) >= 0.99
    assert abs(int(k.n_inliers) - int(r.n_inliers)) <= 2


@pytest.mark.cuda
def test_pose_lm_kernel_few_valid_rows_on_card():
    """N = 1024 with all rows invalid but 12, all in the first 64: the
    cluster's other blocks hold no active point and still take part in
    every reduction."""
    _card()
    p = _pose_problem(5, 1024, 0.0)
    p[5] = torch.zeros(1024, dtype=torch.bool, device="cuda")
    p[5][:60:5] = True
    k = pose_opt.pose_optimize(*p)
    r = pose_opt.pose_optimize_plain(*p)
    torch.cuda.synchronize()
    assert float((k.T - r.T).abs().max()) <= 1e-4
    assert float((k.inliers == r.inliers).float().mean()) >= 0.99
    assert not bool(k.inliers[64:].any())


@pytest.mark.cuda
def test_pose_lm_batch_and_two_launches_bit_identical():
    """A batch of 4 problems in one launch equals each problem alone, and
    two launches give the same bits (a fixed-order block reduction)."""
    _card()
    probs = [_pose_problem(s, 512, 0.2) for s in range(4)]
    stack = [torch.stack([p[i] for p in probs]) for i in range(7)]
    args = stack + [probs[0][7], probs[0][8], config.BAConfig()]
    a = pose_lm_cuda.pose_lm_cuda(*args)
    b = pose_lm_cuda.pose_lm_cuda(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i, p in enumerate(probs):
        one = pose_opt.pose_optimize(*p)
        assert torch.equal(one.T, a[0][i]) and torch.equal(one.inliers,
                                                           a[1][i])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4, 8])
def test_pose_optimize_batch_is_one_launch_of_single_problems(S):
    """`pose_optimize` over [S] problems (the dp step's S sequences at the
    RGB-D path's N = 1024, a third stereo) is one device launch and gives
    each problem the bits of its own single-problem launch; the plain
    version over the batch equals it on each problem too."""
    _card()
    probs = [_pose_problem(10 + s, 1024, 1 / 3) for s in range(S)]
    stack = [torch.stack([p[i] for p in probs]) for i in range(7)]
    args = stack + [probs[0][7], probs[0][8], config.BAConfig()]
    before = pose_lm_cuda.device_launches()
    many = pose_opt.pose_optimize(*args)
    assert pose_lm_cuda.device_launches() == before + 1
    assert many.T.shape == (S, 7) and many.n_inliers.shape == (S,)
    plain = pose_opt.pose_optimize_plain(*args)
    for i, p in enumerate(probs):
        one = pose_opt.pose_optimize(*p)
        for f, x, y in zip(one._fields, one, many):
            assert torch.equal(x, y[i]), (i, f)
        alone = pose_opt.pose_optimize_plain(*p)
        for f, x, y in zip(alone._fields, alone, plain):
            assert torch.equal(x, y[i]), (i, f)
    assert pose_lm_cuda.device_launches() == before + 1 + S


@pytest.mark.cuda
def test_pose_lm_kernel_refuses_cpu_tensors():
    _card()
    p = _pose_problem(0, 128, 0.0)
    cpu = [x.cpu()[None] if torch.is_tensor(x) and x.dim() >= 1 and
           x.shape != (4,) else x for x in p[:7]]
    with pytest.raises(ValueError, match="pose_lm_cuda expects"):
        pose_lm_cuda.pose_lm_cuda(*cpu, p[7], p[8])


def _bow_table(K, W, seed):
    """A seeded [K, W] BoW table (about a third of the words of a row
    non-zero, rows L1-normalised), a query q of the same kind, q itself as
    row 40 and near twins of q at rows 10, 20 and 33 (all, 95% and 90% of
    its words at perturbed values): detection's candidates stand well
    apart from the other rows and from each other."""
    g = torch.Generator().manual_seed(seed)
    t = torch.rand(K, W, generator=g) * (torch.rand(K, W, generator=g) < 0.3)
    q = torch.rand(W, generator=g) * (torch.rand(W, generator=g) < 0.3)
    for r, keep in ((10, 1.0), (20, 0.95), (33, 0.9)):
        t[r] = q * (0.5 + torch.rand(W, generator=g)) * (
            torch.rand(W, generator=g) < keep)
    t = t / t.sum(1, keepdim=True)
    q = q / q.sum()
    t[40] = q
    return q, t


# a score is an f32 sum of up to 10^4 terms |q - t| <= 2 taken in another
# order than the plain version's
BOW_SCORE_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("W", [10_000, 1001], ids=["1e4", "ragged_1001"])
def test_bow_score_kernel_matches_plain_on_card(W):
    """`table_scores` on the card (one kernel call) against its plain
    version on the same CUDA tensors: shared-word counts equal, scores
    within BOW_SCORE_ATOL, 0 / 0 on skipped rows (-1, an id past the
    table); two calls bit-identical, a row's bits the same when listed
    alone; one call counted on the device with its listed rows; loop and
    relocalisation candidates on the card equal to the CPU's.  W = 1001
    takes the kernel's 4-byte loads."""
    _card()
    K = 64
    q, t = _bow_table(K, W, W)
    q, t = q.cuda(), t.cuda()
    ids = [5, -1, 0, 63, 5, 64, 17, -1, 3] + list(range(20, 40))
    rows = torch.tensor(ids, device="cuda")
    listed = (rows >= 0) & (rows < K)
    calls, scored = bow_cuda.device_counts()
    s, c = place_vocab.table_scores(q, t, rows)
    s2, c2 = place_vocab.table_scores(q, t, rows)
    ps, pc = place_vocab.table_scores_plain(q, t, rows)
    torch.cuda.synchronize()
    assert bow_cuda.device_counts() == (calls + 2,
                                        scored + 2 * int(listed.sum()))
    assert s.dtype == torch.float32 and c.dtype == torch.int32
    assert torch.equal(c, pc)
    assert float((s - ps).abs().max()) <= BOW_SCORE_ATOL
    assert (s[~listed] == 0).all() and (c[~listed] == 0).all()
    assert torch.equal(s, s2) and torch.equal(c, c2)
    s1, _ = place_vocab.table_scores(q, t, rows[6:7].int())
    assert torch.equal(s1, s[6:7])
    # the callers on the card against the CPU
    valid = torch.ones(K, dtype=torch.bool)
    valid[2::7] = False
    covis = torch.zeros(K, K, dtype=torch.int32)
    for a, b, w in ((10, 11, 30), (20, 21, 25), (40, 41, 50)):
        covis[a, b] = covis[b, a] = w
    got = []
    for dev in ("cpu", "cuda"):
        args = (t.to(dev), valid.to(dev), covis.to(dev))
        got.append((database.detect_loop_candidates(
            *args, 40, q.to(dev), torch.tensor(0.0, device=dev)),
            database.detect_reloc_candidates(*args, q.to(dev))))
    for a, b in zip(*got):      # the CPU's, the card's
        assert torch.equal(a.ids, b.ids.cpu())
        fin = torch.isfinite(a.scores)
        assert torch.equal(torch.isfinite(b.scores.cpu()), fin)
        assert float((a.scores - b.scores.cpu())[fin].abs().max()) <= \
            BOW_SCORE_ATOL
    assert got[0][0].ids[:3].tolist() == [10, 20, 33]
    assert got[0][1].ids[:4].tolist() == [40, 10, 20, 33]


@pytest.mark.cuda
def test_bow_score_kernel_refuses_what_it_cannot_take():
    """The wrapper raises on a wrong dtype, shape or device, and on a table
    it would have to copy (not contiguous)."""
    _card()
    q, t = _bow_table(64, 4000, 0)
    q, t = q.cuda(), t.cuda()
    rows = torch.arange(8, device="cuda")
    for args in ((q.double(), t, rows), (q, t.double(), rows),
                 (q, t, rows.float()), (q[:-1], t, rows), (q, t[0], rows),
                 (q.cpu(), t, rows), (q, t, rows.cpu()),
                 (q[:2000], t[:, ::2], rows)):
        with pytest.raises(ValueError):
            bow_cuda.table_scores_cuda(*args)
        with pytest.raises(ValueError):
            place_vocab.table_scores(*args)


@pytest.mark.cuda
def test_kernels_count_their_launches_on_the_device():
    """Each kernel adds one to its device count a launch (FAST also the
    planes it covered), also when replayed from a CUDA graph."""
    _card()
    levels = pyramid.level_shapes(480, 640, 8, 1.2)
    atlas = torch.rand(16, 480, 640, device="cuda") * 255
    fast_cuda.fast_nms_atlas(atlas, levels)          # warm
    fast_cuda.reset_device_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fast_cuda.fast_nms_atlas(atlas, levels)
    for _ in range(3):
        g.replay()
    fast_cuda.fast_nms_atlas(atlas, levels)
    assert fast_cuda.device_counts() == (4, 64)
    pose_lm_cuda.reset_device_launches()
    rng = np.random.RandomState(0)
    T0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device="cuda")
    pw = torch.from_numpy((rng.randn(64, 3) + [0, 0, 5]).astype(np.float32)
                          ).cuda()
    uv = torch.from_numpy(rng.rand(64, 2).astype(np.float32) * 100).cuda()
    one = torch.ones(64, device="cuda")
    ok = torch.ones(64, dtype=torch.bool, device="cuda")
    K = torch.tensor([500.0, 500, 320, 240], device="cuda")
    for _ in range(2):
        pose_opt.pose_optimize(T0, pw, uv, -one, one, ok, ~ok, K, 0.0)
    assert pose_lm_cuda.device_launches() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("pred", [False, True])
def test_control_cond_under_capture(pred):
    """`cond` captured once as CUDA graph IF nodes, replayed with each
    predicate: the results equal the eager helper's.  The branches return
    their operands' structure, so both are carries: the results are
    written into the operands, which are returned."""
    _card()
    from orb_slam2_tpu_torch.core import control
    x = torch.linspace(-1, 1, 8, device="cuda")
    y = torch.arange(8.0, device="cuda")
    branches = [lambda a, b: (a + b, a * 2.0),
                lambda a, b: (torch.sin(a) * b, torch.cos(b))]
    p = torch.zeros((), dtype=torch.bool, device="cuda")
    ops, carry = (x.clone(), y.clone()), (x.clone(), y.clone())
    g = torch.cuda.CUDAGraph()
    with control.capture(g, torch.device("cuda")):
        s = control.cond(p, branches[0], branches[1], ops)
        c = control.cond(p, branches[1], control.identity, carry)
    p.fill_(pred)
    g.replay()
    torch.cuda.synchronize()
    want = control.cond(torch.tensor(pred), branches[0], branches[1], (x, y))
    assert all(a is b for a, b in zip(s, ops))
    for a, b in zip(s, want):
        assert torch.equal(a, b)
    want_c = branches[1](x, y) if pred else (x, y)
    assert all(a is b for a, b in zip(c, carry))
    for a, b in zip(carry, want_c):
        assert torch.equal(a, b)
    control.release(g)


def _mono_run(capture: bool, n: int = 12):
    from orb_slam2_tpu_torch.io import synthetic
    from orb_slam2_tpu_torch.pipeline.system import SLAM
    cfg = config.SLAMConfig()
    seq = synthetic.generate(cfg.camera, n_frames=n, n_points=500,
                             trajectory="xyz", seed=0)
    slam = SLAM(cfg, device="cuda", capture=capture)
    for f in range(n):
        slam.track_mono(seq.images[f], seq.timestamps[f])
        if capture and slam.graph_replays:
            torch.cuda.set_sync_debug_mode("error")
    torch.cuda.set_sync_debug_mode(0)
    slam.flush()
    return slam


@pytest.mark.cuda
def test_replayed_frames_equal_eager_frames():
    """The bench mono configuration over 12 frames (10 of them through
    the step): the captured session's replays, under
    set_sync_debug_mode("error") once the graph exists, give the eager
    session's state bit for bit, one graph launch a frame."""
    _card()
    try:
        g = _mono_run(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    e = _mono_run(False)
    assert g.graph_replays == g.frames_stepped >= 10
    for a, b in ((g.state, e.state), (g.ts, e.ts)):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f


def _dp_run(capture: bool, S: int = 2, n: int = 8, seeds=None):
    """`DPProgram` over S RGB-D sequences of tests/test_torch_dp.py's small
    configuration (the renderer's seeds 0 to S - 1, or `seeds`), init and
    n - 1 steps; the steps under set_sync_debug_mode("error") when
    captured (the capture is the first step's)."""
    from orb_slam2_tpu_torch.distributed import dp
    from orb_slam2_tpu_torch.io import synthetic
    cam = config.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                              width=320, height=240, fps=30.0, bf=16.0,
                              th_depth=35.0)
    cfg = config.SLAMConfig(
        sensor=config.RGBD, camera=cam,
        orb=config.ORBConfig(n_features=500, max_keypoints=512),
        cap=config.Capacity(max_keyframes=96, max_points=6144,
                            max_obs_per_kf=512, max_frames=512,
                            local_ba_points=2048))
    seeds = range(S) if seeds is None else seeds
    S = len(seeds)
    seqs = [synthetic.generate(cam, n_frames=n, n_points=300,
                               trajectory="xyz", seed=s) for s in seeds]
    dev = lambda k: torch.as_tensor(np.stack(
        [np.asarray(getattr(q, k), np.float32) for q in seqs])).cuda()
    img, depth, t = dev("images"), dev("depths"), dev("timestamps")
    prog = dp.DPProgram(cfg, S, "cuda", capture=capture)
    prog.init(img[:, 0], depth[:, 0])
    try:
        if capture:
            torch.cuda.set_sync_debug_mode("error")
        for f in range(1, n):
            prog.step(img[:, f], depth[:, f], f, t[:, f])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return prog


@pytest.mark.cuda
def test_dp_replayed_steps_equal_eager_steps():
    """Two RGB-D sequences stepped together over 7 steps (an insertion
    and its stages): the captured program, one graph replay a step and
    no synchronisation after `init`, gives the eager program's state and
    HUDs bit for bit."""
    _card()
    g = _dp_run(True)
    e = _dp_run(False)
    assert g.graph_replays == g.steps == 7 and e.graph_replays == 0
    assert g.capture_s is not None
    np.testing.assert_array_equal(g.huds(), e.huds())
    assert int(g.state.kf_valid.sum()) >= 4
    for a, b in ((g.state, e.state), (g.ts, e.ts)):
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f


@pytest.mark.cuda
def test_dp_sequences_equal_their_own_s1_runs_on_card():
    """Eight RGB-D sequences stepped together (captured, insertions and
    stages included, each stage group on the batch of the sequences at it)
    give each sequence the bits of its own S = 1 run, every state field
    and HUD: the step's cuBLAS / cuSOLVER calls and long float sums run
    once a sequence (`core/seqwise.py`), the extractor's resize matmuls
    and BRIEF GEMM once an image."""
    _card()
    S = 8
    many = _dp_run(True, seeds=range(S))
    assert int(many.state.kf_valid.sum()) >= 2 * S
    for s in range(S):
        one = _dp_run(True, seeds=(s,))
        np.testing.assert_array_equal(many.huds()[:, s], one.huds()[:, 0])
        for a, b in ((many.state, one.state), (many.ts, one.ts)):
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x[s], y[0]), (s, f)
