// Native route-ribbon rasterizer: the host env's route figure, drawn every
// 10 Hz tick.
//
// Bit-equal to the numpy rasterizer it stands in for
// (cadre_tpu_torch/envs/route_fig.py::rasterize_polyline_numpy), on every
// input: centres are sampled along each segment at
// n = max(1, int(hypot(d) / 1.5)) steps of t = k / n, each centre is
// a + t * d in double (built with -ffp-contract=off, so no fused
// multiply-add), and every offset (dx, dy) of the disk dx^2 + dy^2 <=
// (line_width / 2)^2 sets the pixel (rint(cx + dx), rint(cy + dy)), ties
// to even as np.rint rounds (nearbyint in the default rounding mode).
// The JAX package's native rasterizer rounds each centre half away from
// zero and then adds the offsets, which differs from its own numpy path
// where a centre lies exactly on a half pixel; this one keeps numpy's
// result there too.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off raster.cpp
// (driven by cadre_tpu_torch/runtime/native.py; the binding is
// native_raster.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Offset {
  int dx, dy;
};

}  // namespace

extern "C" {

// points: [n_points][2] float64 (x, y) pixel coordinates;
// out: [height * width] uint8, every ribbon pixel set to 255, the rest 0.
void raster_polyline(const double* points, int64_t n_points, int64_t height,
                     int64_t width, double line_width, uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(height * width));
  if (n_points < 2) return;
  const double half = line_width / 2.0;
  const int r = static_cast<int>(std::ceil(half));
  std::vector<Offset> disk;
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx)
      if (static_cast<double>(dx * dx + dy * dy) <= half * half)
        disk.push_back({dx, dy});
  const double w = static_cast<double>(width);
  const double h = static_cast<double>(height);

  auto stamp = [&](double cx, double cy) {
    for (const Offset& o : disk) {
      const double x = std::nearbyint(cx + o.dx);
      const double y = std::nearbyint(cy + o.dy);
      if (!(x >= 0.0 && x < w && y >= 0.0 && y < h)) continue;
      out[static_cast<int64_t>(y) * width + static_cast<int64_t>(x)] = 255;
    }
  };

  stamp(points[0], points[1]);
  for (int64_t i = 0; i + 1 < n_points; ++i) {
    const double ax = points[2 * i], ay = points[2 * i + 1];
    const double dx = points[2 * i + 2] - ax, dy = points[2 * i + 3] - ay;
    const double len = std::hypot(dx, dy);
    int64_t n = static_cast<int64_t>(len / 1.5);
    if (n < 1) n = 1;
    for (int64_t k = 1; k <= n; ++k) {
      const double t = static_cast<double>(k) / static_cast<double>(n);
      stamp(ax + t * dx, ay + t * dy);
    }
  }
}

}  // extern "C"
