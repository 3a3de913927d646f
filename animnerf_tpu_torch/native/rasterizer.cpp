// Z-buffer triangle rasterizer (flat shading), C ABI for ctypes.
//
// Native core of animnerf_tpu_torch/utils/renderer.py, the port's copy of
// the JAX package's native/rasterizer.cpp (the replacement of the
// reference's pyrender+EGL offscreen renderer), built into the port's host
// library by animnerf_tpu_torch/utils/host_lib.py.
// The Python layer computes camera-space vertices and per-face colors;
// this kernel does the pixel fill: perspective-correct barycentric
// interpolation of 1/z with a depth test.
//
//   int raster_fill(const float* uv,      // (F, 3, 2) screen coords
//                   const float* z,       // (F, 3) camera depths (>0 front)
//                   const unsigned char* colors,  // (F, 3) per-face RGB
//                   long long n_faces, int H, int W,
//                   unsigned char* img,   // (H, W, 3) pre-filled background
//                   float* zbuf);         // (H, W) pre-filled +inf

#include <cmath>
#include <cstdint>

extern "C" int raster_fill(const float* uv, const float* z,
                           const unsigned char* colors, long long n_faces,
                           int H, int W, unsigned char* img, float* zbuf) {
    if (!uv || !z || !colors || !img || !zbuf) return -1;
    const float eps = 1e-6f;

    for (long long f = 0; f < n_faces; ++f) {
        const float* p = uv + f * 6;
        const float z0 = z[f * 3 + 0], z1 = z[f * 3 + 1], z2 = z[f * 3 + 2];
        if (z0 <= eps || z1 <= eps || z2 <= eps) continue;

        const float ax = p[0], ay = p[1];
        const float bx = p[2], by = p[3];
        const float cx = p[4], cy = p[5];

        float x0 = ax, x1 = ax, y0 = ay, y1 = ay;
        x0 = std::fmin(x0, std::fmin(bx, cx));
        x1 = std::fmax(x1, std::fmax(bx, cx));
        y0 = std::fmin(y0, std::fmin(by, cy));
        y1 = std::fmax(y1, std::fmax(by, cy));

        int ix0 = (int)std::floor(x0), ix1 = (int)std::floor(x1) + 1;
        int iy0 = (int)std::floor(y0), iy1 = (int)std::floor(y1) + 1;
        if (ix0 < 0) ix0 = 0;
        if (iy0 < 0) iy0 = 0;
        if (ix1 > W) ix1 = W;
        if (iy1 > H) iy1 = H;
        if (ix0 >= ix1 || iy0 >= iy1) continue;

        const float det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
        if (std::fabs(det) < 1e-12f) continue;
        const float inv_det = 1.0f / det;
        const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;

        const unsigned char r = colors[f * 3 + 0];
        const unsigned char g = colors[f * 3 + 1];
        const unsigned char b = colors[f * 3 + 2];

        for (int y = iy0; y < iy1; ++y) {
            const float py = y + 0.5f;
            for (int x = ix0; x < ix1; ++x) {
                const float px = x + 0.5f;
                const float l1 = ((px - ax) * (cy - ay)
                                  - (cx - ax) * (py - ay)) * inv_det;
                const float l2 = ((bx - ax) * (py - ay)
                                  - (px - ax) * (by - ay)) * inv_det;
                const float l0 = 1.0f - l1 - l2;
                if (l0 < 0.f || l1 < 0.f || l2 < 0.f) continue;
                const float zi = 1.0f / (l0 * iz0 + l1 * iz1 + l2 * iz2
                                         + 1e-12f);
                float* zp = zbuf + (long long)y * W + x;
                if (zi < *zp) {
                    *zp = zi;
                    unsigned char* px_out =
                        img + ((long long)y * W + x) * 3;
                    px_out[0] = r;
                    px_out[1] = g;
                    px_out[2] = b;
                }
            }
        }
    }
    return 0;
}
