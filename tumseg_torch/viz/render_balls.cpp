// Software point-cloud sphere-sprite rasterizer with per-pixel depth test.
//
// Native component of the tumseg viewer. ABI- and visually-compatible with
// the reference renderer (visualizer/render_balls_so.cpp:14-56):
//   render_ball(h, w, rgb_buffer, n, int_xyz, c0, c1, c2, radius)
// renders each point as a shaded disc of radius r into an h*w*3 uint8 image,
// keeping the nearest z per pixel, with depth-cue shading
// intensity = clamp(0.3 + 0.7 * (z - zmin) / (zmax - zmin), ., 1.0).
//
// Implementation is original: the sprite (disc offsets + sphere-normal
// shades) is precomputed once into flat arrays, the z range is scanned in a
// separate pass, and the blit loop writes BGR channels from the three color
// planes the Python binding passes (matching the reference's channel order).
//
// Build: see build.sh (g++ -O2 -shared -fPIC). Bound via ctypes
// (tumseg/viz/show3d.py), no Python C API needed.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Sprite {
  std::vector<int> dx, dy, dz;
  std::vector<float> shade;  // dz / r: sphere-normal brightness
};

Sprite make_sprite(int r) {
  Sprite s;
  for (int ox = -r; ox <= r; ++ox) {
    for (int oy = -r; oy <= r; ++oy) {
      const int rr = ox * ox + oy * oy;
      if (rr >= r * r) continue;
      const double oz = std::sqrt(static_cast<double>(r * r - rr));
      s.dx.push_back(ox);
      s.dy.push_back(oy);
      s.dz.push_back(static_cast<int>(oz));
      s.shade.push_back(static_cast<float>(oz / r));
    }
  }
  return s;
}

}  // namespace

extern "C" {

void render_ball(int h, int w, unsigned char* show, int n, int* xyzs,
                 float* c0, float* c1, float* c2, int r) {
  if (r < 1) r = 1;
  if (n <= 0 || h <= 0 || w <= 0) return;

  const Sprite sprite = make_sprite(r);
  std::vector<int64_t> depth(static_cast<size_t>(h) * w,
                             std::numeric_limits<int64_t>::min());

  // z range across all points (inflated by the sprite radius) for depth cue
  double zmin = xyzs[2] - r, zmax = xyzs[2] + r;
  for (int i = 1; i < n; ++i) {
    const double z = xyzs[i * 3 + 2];
    if (z - r < zmin) zmin = z - r;
    if (z + r > zmax) zmax = z + r;
  }
  const double zspan = (zmax > zmin) ? (zmax - zmin) : 1.0;

  const size_t m = sprite.dx.size();
  for (int i = 0; i < n; ++i) {
    const int px = xyzs[i * 3 + 0];
    const int py = xyzs[i * 3 + 1];
    const int pz = xyzs[i * 3 + 2];
    for (size_t j = 0; j < m; ++j) {
      const int x = px + sprite.dx[j];
      const int y = py + sprite.dy[j];
      if (x < 0 || x >= h || y < 0 || y >= w) continue;
      const int64_t z = pz + sprite.dz[j];
      const size_t pix = static_cast<size_t>(x) * w + y;
      if (depth[pix] >= z) continue;
      depth[pix] = z;
      double intensity = (z - zmin) / zspan * 0.7 + 0.3;
      if (intensity > 1.0) intensity = 1.0;
      const float s = static_cast<float>(intensity) * sprite.shade[j];
      unsigned char* out = show + pix * 3;
      out[0] = static_cast<unsigned char>(s * c2[i]);
      out[1] = static_cast<unsigned char>(s * c0[i]);
      out[2] = static_cast<unsigned char>(s * c1[i]);
    }
  }
}

}  // extern "C"
