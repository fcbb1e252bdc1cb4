// Native preprocessing kernels for the host-side BraTS pipeline.
//
// The reference's offline stage (SURVEY.md §3.1) is per-patient numpy:
// z-score within the nonzero brain mask + foreground bounding box.  These
// are the host hot loops (the TPU never sees raw volumes), so they get a
// C++/OpenMP implementation; Python falls back to numpy when the shared
// library is unavailable (see _native.py).
//
// Accumulations use double (Kahan unnecessary at BraTS volume sizes:
// ~9M voxels, |x| < 1e5 → double sum error ~1e-7 relative), matching the
// numpy implementation which also accumulates in float64.

#include <cstdint>
#include <cmath>

extern "C" {

// z-score normalize `vol` (length n) in place within its nonzero mask.
// Returns the number of nonzero voxels (0 => volume left untouched/zeroed).
int64_t zscore_in_mask(float* vol, int64_t n) {
    double sum = 0.0, sumsq = 0.0;
    int64_t count = 0;
#pragma omp parallel for reduction(+:sum, sumsq, count) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const float v = vol[i];
        if (v != 0.0f) {
            sum += v;
            sumsq += static_cast<double>(v) * v;
            ++count;
        }
    }
    if (count == 0) return 0;
    const double mean = sum / count;
    double var = sumsq / count - mean * mean;
    if (var < 0.0) var = 0.0;
    double std = std::sqrt(var * (static_cast<double>(count) / count));
    // numpy's std is population std (ddof=0) — same formula.
    if (std == 0.0) std = 1.0;
    const float fmean = static_cast<float>(mean);
    const float finv = static_cast<float>(1.0 / std);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const float v = vol[i];
        vol[i] = (v != 0.0f) ? (v - fmean) * finv : 0.0f;
    }
    return count;
}

// Tight bounding box of the union of nonzero voxels over `m` volumes of
// shape (d, h, w), C-contiguous.  Writes [d0, d1, h0, h1, w0, w1) into
// `bbox` (end-exclusive).  Returns 1 if any voxel is nonzero else 0.
int32_t union_foreground_bbox(const float* const* vols, int64_t m,
                              int64_t d, int64_t h, int64_t w,
                              int64_t* bbox) {
    int64_t d0 = d, d1 = -1, h0 = h, h1 = -1, w0 = w, w1 = -1;
#pragma omp parallel
    {
        int64_t ld0 = d, ld1 = -1, lh0 = h, lh1 = -1, lw0 = w, lw1 = -1;
#pragma omp for schedule(static) nowait
        for (int64_t z = 0; z < d; ++z) {
            for (int64_t y = 0; y < h; ++y) {
                const int64_t base = (z * h + y) * w;
                for (int64_t x = 0; x < w; ++x) {
                    bool nz = false;
                    for (int64_t k = 0; k < m && !nz; ++k)
                        nz = vols[k][base + x] != 0.0f;
                    if (nz) {
                        if (z < ld0) ld0 = z;
                        if (z > ld1) ld1 = z;
                        if (y < lh0) lh0 = y;
                        if (y > lh1) lh1 = y;
                        if (x < lw0) lw0 = x;
                        if (x > lw1) lw1 = x;
                    }
                }
            }
        }
#pragma omp critical
        {
            if (ld0 < d0) d0 = ld0;
            if (ld1 > d1) d1 = ld1;
            if (lh0 < h0) h0 = lh0;
            if (lh1 > h1) h1 = lh1;
            if (lw0 < w0) w0 = lw0;
            if (lw1 > w1) w1 = lw1;
        }
    }
    if (d1 < 0) {  // empty: full volume (matches foreground_bbox fallback)
        bbox[0] = 0; bbox[1] = d;
        bbox[2] = 0; bbox[3] = h;
        bbox[4] = 0; bbox[5] = w;
        return 0;
    }
    bbox[0] = d0; bbox[1] = d1 + 1;
    bbox[2] = h0; bbox[3] = h1 + 1;
    bbox[4] = w0; bbox[5] = w1 + 1;
    return 1;
}

}  // extern "C"

// Batched random-patch crop: the online-generator hot loop (SURVEY.md §3.2
// "generator.next()" — host batch assembly).  Copies n patches of
// (pd, ph, pw) voxels from per-sample source volumes into one contiguous
// batch buffer.  Operates on BYTES per voxel-row so one entry point serves
// f32 images (4ch), f32 region labels (3ch) and int class labels alike.
// OpenMP over (sample, depth-plane); each inner copy is a contiguous
// memcpy of pw*vox_bytes.
extern "C" {

void crop_batch_bytes(const char** srcs,
                      const int64_t* dims,    // (n, 3): D, H, W per sample
                      const int64_t* starts,  // (n, 3): crop origin
                      char* out, int64_t n,
                      int64_t pd, int64_t ph, int64_t pw,
                      int64_t vox_bytes) {
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t d = 0; d < pd; ++d) {
            const int64_t H = dims[i * 3 + 1], W = dims[i * 3 + 2];
            const int64_t sd = starts[i * 3], sh = starts[i * 3 + 1],
                          sw = starts[i * 3 + 2];
            const char* src = srcs[i]
                + (((sd + d) * H + sh) * W + sw) * vox_bytes;
            char* dst = out + (((i * pd + d) * ph) * pw) * vox_bytes;
            for (int64_t h = 0; h < ph; ++h) {
                __builtin_memcpy(dst + h * pw * vox_bytes,
                                 src + h * W * vox_bytes,
                                 static_cast<size_t>(pw * vox_bytes));
            }
        }
    }
}

}  // extern "C" (crop_batch_bytes)
