// PNG scanline unfiltering (PNG specification, section 9: filter types
// 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
//
// The Sub, Average and Paeth filters carry a dependency from left to right
// along a row and every filter but None one from row to row, so a decoder
// in array operations loops over pixels; this one pass over the bytes runs
// at memory speed.  C ABI for ctypes:
//
//   png_unfilter(in, out, height, stride, bpp) -> 0, or -(row + 1) for a
//   row whose filter byte is not 0-4
//
// `in` holds `height` rows of one filter byte and `stride` data bytes (the
// inflated IDAT stream), `out` receives `height` x `stride` bytes, `bpp` is
// the bytes per complete pixel (at least 1).
//
// Built with g++ -O3 -shared -fPIC at first use into the package's _build/
// (orb_slam2_tpu_torch/native_build.py).

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, uint8_t* out, long height,
                            long stride, int bpp) {
  const uint8_t* prev = nullptr;
  for (long r = 0; r < height; ++r) {
    const uint8_t* src = in + r * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* dst = out + r * stride;
    for (long i = 0; i < stride; ++i) {
      const int a = i >= bpp ? dst[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -static_cast<int>(r + 1);
      }
      dst[i] = static_cast<uint8_t>(src[i] + pred);
    }
    prev = dst;
  }
  return 0;
}
