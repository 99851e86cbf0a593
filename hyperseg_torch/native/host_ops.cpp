// Native host-side kernels of the data path, a copy of
// hyperseg_tpu/native/host_ops.cpp.
//
// Single-pass C++ forms of the reference's multi-pass numpy: CamVid's
// per-colour mask scan (camvid.py:93-102), Cityscapes' id -> train id table
// and the ToTensor/Normalize pair. Called through ctypes from
// hyperseg_torch/native/__init__.py in the loader's worker processes; they
// hold no Python state, and ctypes releases the GIL around each call.
//
// Built at first use by hyperseg_torch/native/__init__.py
// (g++ -O3 -march=native -shared -fPIC -std=c++17) into _build/.

#include <cstdint>
#include <cstring>

extern "C" {

// RGB-coded label mask -> class indices. colors: (n_colors, 3) uint8 table;
// pixels matching no table entry map to `fill` (255 = ignore).
// Single pass: colors pack into 24-bit keys probed through a tiny open
// hash, instead of n_colors full-image comparisons.
void rgb_label_to_index(const uint8_t* rgb, int64_t n_pixels,
                        const uint8_t* colors, int n_colors,
                        uint8_t fill, uint8_t* out) {
    // 1024-slot open-addressing table (n_colors is tiny: 12/21/34)
    const int SLOTS = 1024;
    uint32_t keys[SLOTS];
    uint8_t vals[SLOTS];
    memset(keys, 0xff, sizeof(keys));
    for (int i = 0; i < n_colors; ++i) {
        uint32_t key = (uint32_t(colors[3 * i]) << 16) |
                       (uint32_t(colors[3 * i + 1]) << 8) |
                       uint32_t(colors[3 * i + 2]);
        uint32_t h = (key * 2654435761u) & (SLOTS - 1);
        while (keys[h] != 0xffffffffu && keys[h] != key) h = (h + 1) & (SLOTS - 1);
        keys[h] = key;
        vals[h] = uint8_t(i);
    }
    for (int64_t p = 0; p < n_pixels; ++p) {
        uint32_t key = (uint32_t(rgb[3 * p]) << 16) |
                       (uint32_t(rgb[3 * p + 1]) << 8) |
                       uint32_t(rgb[3 * p + 2]);
        uint32_t h = (key * 2654435761u) & (SLOTS - 1);
        uint8_t v = fill;
        while (keys[h] != 0xffffffffu) {
            if (keys[h] == key) { v = vals[h]; break; }
            h = (h + 1) & (SLOTS - 1);
        }
        out[p] = v;
    }
}

// uint8 lookup-table label remap (Cityscapes id -> train_id,
// cityscapes.py:208-211). Values >= table_len map to `fill`.
void map_labels_u8(const uint8_t* labels, int64_t n, const uint8_t* table,
                   int table_len, uint8_t fill, uint8_t* out) {
    uint8_t lut[256];
    for (int i = 0; i < 256; ++i) lut[i] = (i < table_len) ? table[i] : fill;
    for (int64_t p = 0; p < n; ++p) out[p] = lut[labels[p]];
}

// Fused uint8 HWC image -> normalized float32: out = (x/255 - mean) / std.
// Replaces the ToTensor + Normalize double pass (seg_transforms.py:66-114).
void normalize_u8_to_f32(const uint8_t* img, int64_t n_pixels, int channels,
                         const float* mean, const float* std_, float* out) {
    float scale[8], bias[8];  // channels <= 8 in practice (RGB)
    for (int c = 0; c < channels; ++c) {
        scale[c] = 1.0f / (255.0f * std_[c]);
        bias[c] = -mean[c] / std_[c];
    }
    for (int64_t p = 0; p < n_pixels; ++p) {
        const uint8_t* src = img + p * channels;
        float* dst = out + p * channels;
        for (int c = 0; c < channels; ++c) {
            dst[c] = float(src[c]) * scale[c] + bias[c];
        }
    }
}

}  // extern "C"
