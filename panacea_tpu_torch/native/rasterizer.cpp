// Native rasterization kernels for the BEV-layout condition renderer.
//
// The reference data pipeline leans on OpenCV's C++ rasterizers plus Python
// loops (nuscenes_datasets_video.py:286-341; render.py:47-103). These kernels
// cover the hot per-frame x per-view drawing ops with a minimal C ABI so the
// Python side binds via ctypes (no pybind11 in this image):
//
//   * fill_depth_boxes  — per-class min-depth rectangle fill (10-ch maps)
//   * draw_polyline     — solid thick polyline with round joins
//   * fill_convex_poly  — scanline convex polygon fill
//
// Build: g++ -O3 -shared -fPIC rasterizer.cpp -o librasterizer.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// img: (H, W, C) uint8, channel-interleaved. boxes: (N, 4) float (x0,y0,x1,y1).
// Writes min(img, depth*3) into channel labels[i] inside each box.
void fill_depth_boxes(uint8_t* img, int H, int W, int C,
                      const float* boxes, const int64_t* labels,
                      const float* depths, int64_t N) {
    for (int64_t i = 0; i < N; ++i) {
        int c = static_cast<int>(labels[i]);
        if (c < 0 || c >= C) continue;
        float d = depths[i] * 3.0f;
        uint8_t dv = d <= 0.f ? 0 : (d >= 255.f ? 255 : (uint8_t)d);
        int x0 = std::max(0, (int)boxes[i * 4 + 0]);
        int y0 = std::max(0, (int)boxes[i * 4 + 1]);
        int x1 = std::min(W, (int)boxes[i * 4 + 2]);
        int y1 = std::min(H, (int)boxes[i * 4 + 3]);
        for (int y = y0; y < y1; ++y) {
            uint8_t* row = img + ((int64_t)y * W) * C + c;
            for (int x = x0; x < x1; ++x) {
                uint8_t* p = row + (int64_t)x * C;
                if (*p > dv) *p = dv;
            }
        }
    }
}

static inline void put_px(uint8_t* img, int H, int W, int x, int y,
                          const uint8_t* color) {
    if (x < 0 || x >= W || y < 0 || y >= H) return;
    uint8_t* p = img + ((int64_t)y * W + x) * 3;
    p[0] = color[0]; p[1] = color[1]; p[2] = color[2];
}

// stamp a filled disc of radius r at (cx, cy)
static void stamp_disc(uint8_t* img, int H, int W, int cx, int cy, int r,
                       const uint8_t* color) {
    for (int dy = -r; dy <= r; ++dy)
        for (int dx = -r; dx <= r; ++dx)
            if (dx * dx + dy * dy <= r * r)
                put_px(img, H, W, cx + dx, cy + dy, color);
}

// img: (H, W, 3) uint8. pts: (K, 2) int32 pixel coords. Solid thick strokes.
void draw_polyline(uint8_t* img, int H, int W, const int32_t* pts, int64_t K,
                   uint8_t c0, uint8_t c1, uint8_t c2, int thickness) {
    uint8_t color[3] = {c0, c1, c2};
    int r = std::max(0, thickness / 2);
    for (int64_t i = 0; i + 1 < K; ++i) {
        int x0 = pts[i * 2], y0 = pts[i * 2 + 1];
        int x1 = pts[(i + 1) * 2], y1 = pts[(i + 1) * 2 + 1];
        int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
        int steps = std::max(dx, dy);
        if (steps == 0) { stamp_disc(img, H, W, x0, y0, r, color); continue; }
        for (int s = 0; s <= steps; ++s) {
            int x = x0 + (int)std::lround((double)(x1 - x0) * s / steps);
            int y = y0 + (int)std::lround((double)(y1 - y0) * s / steps);
            if (r == 0) put_px(img, H, W, x, y, color);
            else stamp_disc(img, H, W, x, y, r, color);
        }
    }
}

// scanline fill of a convex polygon; pts: (K, 2) int32
void fill_convex_poly(uint8_t* img, int H, int W, const int32_t* pts,
                      int64_t K, uint8_t c0, uint8_t c1, uint8_t c2) {
    if (K < 3) return;
    int ymin = H, ymax = -1;
    for (int64_t i = 0; i < K; ++i) {
        ymin = std::min(ymin, pts[i * 2 + 1]);
        ymax = std::max(ymax, pts[i * 2 + 1]);
    }
    ymin = std::max(0, ymin);
    ymax = std::min(H - 1, ymax);
    uint8_t color[3] = {c0, c1, c2};
    for (int y = ymin; y <= ymax; ++y) {
        double xl = 1e30, xr = -1e30;
        for (int64_t i = 0; i < K; ++i) {
            int64_t j = (i + 1) % K;
            double y0 = pts[i * 2 + 1], y1 = pts[j * 2 + 1];
            double x0 = pts[i * 2], x1 = pts[j * 2];
            if ((y >= y0 && y <= y1) || (y >= y1 && y <= y0)) {
                double t = (y1 == y0) ? 0.0 : (y - y0) / (y1 - y0);
                double x = x0 + t * (x1 - x0);
                xl = std::min(xl, x);
                xr = std::max(xr, x);
            }
        }
        if (xr < xl) continue;
        int a = std::max(0, (int)std::ceil(xl));
        int b = std::min(W - 1, (int)std::floor(xr));
        for (int x = a; x <= b; ++x)
            put_px(img, H, W, x, y, color);
    }
}

}  // extern "C"
