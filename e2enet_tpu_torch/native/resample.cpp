// Native host resampler for the training augmentation pipeline: the
// port's own copy of e2enet_tpu/native/resample.cpp, the same code, so that
// both packages warp a batch to the same bits.
//
// Why native: the reference hides augmentation cost behind a pool of worker
// processes (batchgenerators MultiThreadedAugmenter); the trainer here runs
// its augmentation on one or a few background threads, so the per-sample
// spatial warp (scipy.ndimage.affine_transform, order-3 spline per channel
// + one pass PER LABEL for the segmentation) would set the pipeline's pace.
// This file is a cache-friendly single-pass reimplementation:
//   * affine_warp_f32: nearest / trilinear / cubic warp of (C, D, H, W)
//     volumes. Coordinate convention matches scipy.ndimage.affine_transform:
//     input_coord = M @ output_coord + offset, constant (cval) boundary.
//     order 3 uses Keys cubic convolution (a = -0.5) rather than scipy's
//     prefiltered cubic B-spline — for random augmentation the interpolant
//     family is equivalent in effect and needs no prefilter pass.
//   * affine_warp_seg_f32: the reference's per-label linear-interpolate +
//     (>= 0.5) threshold semantics (batchgenerators interpolate_img(is_seg),
//     mirrored in data/augment.py:_interpolate_seg) in ONE pass: gather the
//     8 trilinear corners' labels and weights; the result is the largest
//     label whose accumulated weight reaches 0.5 (ties -> larger label,
//     matching the ascending-label overwrite loop), else cval.
//
// Built at first use by e2enet_tpu_torch/native/__init__.py (g++ -O3) into
// build/; the augmentation takes scipy's route where no compiler is found.
#include <cmath>
#include <cstddef>

namespace {

inline float sample1(const float* a, int D, int H, int W,
                     int z, int y, int x, float cval) {
    if ((unsigned)z >= (unsigned)D || (unsigned)y >= (unsigned)H ||
        (unsigned)x >= (unsigned)W)
        return cval;
    return a[((size_t)z * H + y) * W + x];
}

inline void cubic_weights(double t, double w[4]) {
    // Keys cubic convolution, a = -0.5
    const double t2 = t * t, t3 = t2 * t;
    w[0] = -0.5 * t3 + t2 - 0.5 * t;
    w[1] = 1.5 * t3 - 2.5 * t2 + 1.0;
    w[2] = -1.5 * t3 + 2.0 * t2 + 0.5 * t;
    w[3] = 0.5 * t3 - 0.5 * t2;
}

}  // namespace

extern "C" {

void affine_warp_f32(const float* src, int C, int D, int H, int W,
                     const double* M, const double* off, float* dst,
                     int OD, int OH, int OW, int order, float cval) {
    const size_t in_sz = (size_t)D * H * W;
    const size_t out_sz = (size_t)OD * OH * OW;
    for (int z = 0; z < OD; ++z) {
        for (int y = 0; y < OH; ++y) {
            const double bz = M[0] * z + M[1] * y + off[0];
            const double by = M[3] * z + M[4] * y + off[1];
            const double bx = M[6] * z + M[7] * y + off[2];
            float* orow = dst + ((size_t)z * OH + y) * OW;
            for (int x = 0; x < OW; ++x) {
                const double cz = bz + M[2] * x;
                const double cy = by + M[5] * x;
                const double cx = bx + M[8] * x;
                // scipy mode='constant': coordinates outside [0, size-1]
                // produce cval outright (no edge interpolation)
                if (cz < 0.0 || cz > D - 1 || cy < 0.0 || cy > H - 1 ||
                    cx < 0.0 || cx > W - 1) {
                    for (int c = 0; c < C; ++c)
                        orow[(size_t)c * out_sz + x] = cval;
                    continue;
                }
                if (order == 0) {
                    const int zi = (int)std::floor(cz + 0.5);
                    const int yi = (int)std::floor(cy + 0.5);
                    const int xi = (int)std::floor(cx + 0.5);
                    for (int c = 0; c < C; ++c)
                        orow[(size_t)c * out_sz + x] = sample1(
                            src + (size_t)c * in_sz, D, H, W, zi, yi, xi,
                            cval);
                } else if (order == 1) {
                    const int z0 = (int)std::floor(cz);
                    const int y0 = (int)std::floor(cy);
                    const int x0 = (int)std::floor(cx);
                    const double fz = cz - z0, fy = cy - y0, fx = cx - x0;
                    const double wz[2] = {1.0 - fz, fz};
                    const double wy[2] = {1.0 - fy, fy};
                    const double wx[2] = {1.0 - fx, fx};
                    for (int c = 0; c < C; ++c) {
                        const float* a = src + (size_t)c * in_sz;
                        double v = 0.0;
                        for (int dz = 0; dz < 2; ++dz)
                            for (int dy = 0; dy < 2; ++dy)
                                for (int dx = 0; dx < 2; ++dx)
                                    v += wz[dz] * wy[dy] * wx[dx] *
                                         sample1(a, D, H, W, z0 + dz,
                                                 y0 + dy, x0 + dx, cval);
                        orow[(size_t)c * out_sz + x] = (float)v;
                    }
                } else {  // cubic
                    const int z0 = (int)std::floor(cz);
                    const int y0 = (int)std::floor(cy);
                    const int x0 = (int)std::floor(cx);
                    double wz[4], wy[4], wx[4];
                    cubic_weights(cz - z0, wz);
                    cubic_weights(cy - y0, wy);
                    cubic_weights(cx - x0, wx);
                    for (int c = 0; c < C; ++c) {
                        const float* a = src + (size_t)c * in_sz;
                        double v = 0.0;
                        for (int dz = 0; dz < 4; ++dz) {
                            if (wz[dz] == 0.0) continue;
                            double vy = 0.0;
                            for (int dy = 0; dy < 4; ++dy) {
                                if (wy[dy] == 0.0) continue;
                                double vx = 0.0;
                                for (int dx = 0; dx < 4; ++dx)
                                    vx += wx[dx] * sample1(
                                        a, D, H, W, z0 - 1 + dz,
                                        y0 - 1 + dy, x0 - 1 + dx, cval);
                                vy += wy[dy] * vx;
                            }
                            v += wz[dz] * vy;
                        }
                        orow[(size_t)c * out_sz + x] = (float)v;
                    }
                }
            }
        }
    }
}

void affine_warp_seg_f32(const float* seg, int D, int H, int W,
                         const double* M, const double* off, float* dst,
                         int OD, int OH, int OW, float cval) {
    for (int z = 0; z < OD; ++z) {
        for (int y = 0; y < OH; ++y) {
            const double bz = M[0] * z + M[1] * y + off[0];
            const double by = M[3] * z + M[4] * y + off[1];
            const double bx = M[6] * z + M[7] * y + off[2];
            float* orow = dst + ((size_t)z * OH + y) * OW;
            for (int x = 0; x < OW; ++x) {
                const double cz = bz + M[2] * x;
                const double cy = by + M[5] * x;
                const double cx = bx + M[8] * x;
                if (cz < 0.0 || cz > D - 1 || cy < 0.0 || cy > H - 1 ||
                    cx < 0.0 || cx > W - 1) {
                    orow[x] = cval;
                    continue;
                }
                const int z0 = (int)std::floor(cz);
                const int y0 = (int)std::floor(cy);
                const int x0 = (int)std::floor(cx);
                const double fz = cz - z0, fy = cy - y0, fx = cx - x0;
                const double wz[2] = {1.0 - fz, fz};
                const double wy[2] = {1.0 - fy, fy};
                const double wx[2] = {1.0 - fx, fx};
                float labs[8];
                double wts[8];
                int n = 0;
                for (int dz = 0; dz < 2; ++dz)
                    for (int dy = 0; dy < 2; ++dy)
                        for (int dx = 0; dx < 2; ++dx) {
                            const int zi = z0 + dz, yi = y0 + dy,
                                      xi = x0 + dx;
                            if ((unsigned)zi >= (unsigned)D ||
                                (unsigned)yi >= (unsigned)H ||
                                (unsigned)xi >= (unsigned)W)
                                continue;
                            const double w =
                                wz[dz] * wy[dy] * wx[dx];
                            if (w == 0.0) continue;
                            const float lab =
                                seg[((size_t)zi * H + yi) * W + xi];
                            int k = 0;
                            for (; k < n; ++k)
                                if (labs[k] == lab) { wts[k] += w; break; }
                            if (k == n) { labs[n] = lab; wts[n] = w; ++n; }
                        }
                float best = cval;
                bool found = false;
                for (int k = 0; k < n; ++k)
                    if (wts[k] >= 0.5 &&
                        (!found || labs[k] > best)) {
                        best = labs[k];
                        found = true;
                    }
                orow[x] = best;
            }
        }
    }
}

}  // extern "C"
