// Native low-bit sample unpacking for SIGPROC filterbank data.
//
// SIGPROC packs 1/2/4-bit samples LSB-first within each byte (the
// convention of the wider sigproc tool ecosystem): the channel with the
// lowest index sits in the least-significant bits.  The Python fallback
// in ``io/lowbit.py`` implements identical semantics; these loops exist
// because the hot streaming driver reads hundreds of MB per chunk.
//
// Unpacking goes through a 256-entry lookup table per width (byte ->
// precomputed float vector, copied with one small memcpy) — the
// shift-and-mask-per-bit form compiles to scalar byte extracts and loses
// to numpy's vectorised broadcasting.
//
// Exported C ABI (ctypes): each unpack function expands ``n_bytes``
// packed input bytes into ``n_bytes * (8 / nbits)`` float32 outputs.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

template <int NBITS>
struct Lut {
    static constexpr int kPer = 8 / NBITS;
    float table[256][kPer];
    Lut() {
        constexpr unsigned mask = (1u << NBITS) - 1u;
        for (unsigned b = 0; b < 256; ++b)
            for (int j = 0; j < kPer; ++j)
                table[b][j] = static_cast<float>((b >> (j * NBITS)) & mask);
    }
};

template <int NBITS>
void unpack_impl(const uint8_t *in, float *out, size_t n_bytes) {
    static const Lut<NBITS> lut;  // built once at first call
    constexpr int per = Lut<NBITS>::kPer;
    for (size_t i = 0; i < n_bytes; ++i)
        std::memcpy(out + i * per, lut.table[in[i]], per * sizeof(float));
}

inline uint8_t clip_u(float v, uint8_t maxval) {
    // round-half-to-even to match the numpy oracle's np.rint exactly
    // (the default FP rounding mode; v + 0.5 truncation would differ on
    // exact halves and make output depend on which path built)
    float r = std::nearbyintf(v);
    if (r <= 0.0f) return 0;
    return r > static_cast<float>(maxval) ? maxval
                                          : static_cast<uint8_t>(r);
}

}  // namespace

extern "C" {

void unpack1(const uint8_t *in, float *out, size_t n) { unpack_impl<1>(in, out, n); }
void unpack2(const uint8_t *in, float *out, size_t n) { unpack_impl<2>(in, out, n); }
void unpack4(const uint8_t *in, float *out, size_t n) { unpack_impl<4>(in, out, n); }

// Packing (writer side): values are clipped to the representable range.

void pack1(const float *in, uint8_t *out, size_t n_bytes) {
    for (size_t i = 0; i < n_bytes; ++i) {
        const float *s = in + i * 8;
        uint8_t b = 0;
        for (int j = 0; j < 8; ++j)
            b |= static_cast<uint8_t>(clip_u(s[j], 1) << j);
        out[i] = b;
    }
}

void pack2(const float *in, uint8_t *out, size_t n_bytes) {
    for (size_t i = 0; i < n_bytes; ++i) {
        const float *s = in + i * 4;
        out[i] = static_cast<uint8_t>(
            clip_u(s[0], 3) | (clip_u(s[1], 3) << 2) |
            (clip_u(s[2], 3) << 4) | (clip_u(s[3], 3) << 6));
    }
}

void pack4(const float *in, uint8_t *out, size_t n_bytes) {
    for (size_t i = 0; i < n_bytes; ++i) {
        const float *s = in + i * 2;
        out[i] = static_cast<uint8_t>(clip_u(s[0], 15) |
                                      (clip_u(s[1], 15) << 4));
    }
}

}  // extern "C"
