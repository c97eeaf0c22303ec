// Native ORCA engine (C++), fresh implementation of the published algorithm
// (van den Berg, Guy, Lin, Manocha, "Reciprocal n-body collision avoidance",
// ISRR 2011). Host-side runtime counterpart of sicnav_tpu/ops/orca.py:
// used as a fast CPU oracle for parity tests and for bulk host-side
// scenario rollouts / dataset generation, replacing the role the Python-RVO2
// C++ library plays in the reference (crowd_sim_plus/envs/policy/orca*.py).
//
// C ABI only (driven through ctypes; no pybind11 dependency).
//
// Attribution: the incremental 2D linear-programming structure
// (linearProgram1/2/3) necessarily parallels the RVO2 library
// (https://gamma.cs.unc.edu/RVO2/, Apache-2.0), the canonical
// implementation of the published ORCA algorithm; this file was written
// fresh against the paper and the RVO2 public API semantics.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <vector>

namespace {

constexpr float RVO_EPSILON = 1e-5f;

struct Vec2 {
  float x = 0.f, y = 0.f;
  Vec2() = default;
  Vec2(float x_, float y_) : x(x_), y(y_) {}
  Vec2 operator+(const Vec2& o) const { return {x + o.x, y + o.y}; }
  Vec2 operator-(const Vec2& o) const { return {x - o.x, y - o.y}; }
  Vec2 operator*(float s) const { return {x * s, y * s}; }
  Vec2 operator-() const { return {-x, -y}; }
};

inline Vec2 operator*(float s, const Vec2& v) { return v * s; }
inline float dot(const Vec2& a, const Vec2& b) { return a.x * b.x + a.y * b.y; }
inline float det(const Vec2& a, const Vec2& b) { return a.x * b.y - a.y * b.x; }
inline float abs_sq(const Vec2& v) { return dot(v, v); }
inline float norm(const Vec2& v) { return std::sqrt(abs_sq(v)); }
inline Vec2 normalize(const Vec2& v) {
  float n = norm(v);
  return n > 0.f ? v * (1.f / n) : Vec2();
}

struct Line {
  Vec2 point;
  Vec2 dir;
};

// --- incremental 2D linear program (published ORCA LP) --------------------

bool linear_program1(const std::vector<Line>& lines, size_t line_no,
                     float radius, const Vec2& opt_vel, bool dir_opt,
                     Vec2* result) {
  const Vec2& pt = lines[line_no].point;
  const Vec2& dr = lines[line_no].dir;
  float dot_product = dot(pt, dr);
  float disc = dot_product * dot_product + radius * radius - abs_sq(pt);
  if (disc < 0.f) return false;
  float sqrt_disc = std::sqrt(disc);
  float t_left = -dot_product - sqrt_disc;
  float t_right = -dot_product + sqrt_disc;

  for (size_t i = 0; i < line_no; ++i) {
    float denom = det(dr, lines[i].dir);
    float numer = det(lines[i].dir, pt - lines[i].point);
    if (std::fabs(denom) <= RVO_EPSILON) {
      if (numer < 0.f) return false;
      continue;
    }
    float t = numer / denom;
    if (denom >= 0.f)
      t_right = std::min(t_right, t);
    else
      t_left = std::max(t_left, t);
    if (t_left > t_right) return false;
  }

  float t;
  if (dir_opt) {
    t = dot(opt_vel, dr) > 0.f ? t_right : t_left;
  } else {
    t = dot(dr, opt_vel - pt);
    t = std::min(std::max(t, t_left), t_right);
  }
  *result = pt + t * dr;
  return true;
}

size_t linear_program2(const std::vector<Line>& lines, float radius,
                       const Vec2& opt_vel, bool dir_opt, Vec2* result) {
  if (dir_opt) {
    *result = opt_vel * radius;
  } else if (abs_sq(opt_vel) > radius * radius) {
    *result = normalize(opt_vel) * radius;
  } else {
    *result = opt_vel;
  }
  for (size_t i = 0; i < lines.size(); ++i) {
    if (det(lines[i].dir, lines[i].point - *result) > 0.f) {
      Vec2 temp = *result;
      if (!linear_program1(lines, i, radius, opt_vel, dir_opt, result)) {
        *result = temp;
        return i;
      }
    }
  }
  return lines.size();
}

void linear_program3(const std::vector<Line>& lines, size_t num_obst,
                     size_t begin, float radius, Vec2* result) {
  float distance = 0.f;
  for (size_t i = begin; i < lines.size(); ++i) {
    if (det(lines[i].dir, lines[i].point - *result) > distance) {
      std::vector<Line> proj(lines.begin(), lines.begin() + num_obst);
      for (size_t j = num_obst; j < i; ++j) {
        Line line;
        float denom = det(lines[i].dir, lines[j].dir);
        if (std::fabs(denom) <= RVO_EPSILON) {
          if (dot(lines[i].dir, lines[j].dir) > 0.f) continue;
          line.point = 0.5f * (lines[i].point + lines[j].point);
        } else {
          line.point = lines[i].point +
                       (det(lines[j].dir, lines[i].point - lines[j].point) /
                        denom) * lines[i].dir;
        }
        line.dir = normalize(lines[j].dir - lines[i].dir);
        proj.push_back(line);
      }
      Vec2 temp = *result;
      if (linear_program2(proj, radius, Vec2(-lines[i].dir.y, lines[i].dir.x),
                          true, result) < proj.size()) {
        *result = temp;
      }
      distance = det(lines[i].dir, lines[i].point - *result);
    }
  }
}

// --- half-plane construction ----------------------------------------------

void add_agent_line(std::vector<Line>* lines, const Vec2& pos, const Vec2& vel,
                    float rad, const Vec2& opos, const Vec2& ovel, float orad,
                    float time_horizon, float dt) {
  Vec2 rel_pos = opos - pos;
  Vec2 rel_vel = vel - ovel;
  float dist_sq = abs_sq(rel_pos);
  float comb_r = rad + orad;
  float comb_r_sq = comb_r * comb_r;

  Line line;
  Vec2 u;
  if (dist_sq > comb_r_sq) {
    float inv_th = 1.f / time_horizon;
    Vec2 w = rel_vel - inv_th * rel_pos;
    float w_len_sq = abs_sq(w);
    float dot1 = dot(w, rel_pos);
    if (dot1 < 0.f && dot1 * dot1 > comb_r_sq * w_len_sq) {
      float w_len = std::sqrt(w_len_sq);
      Vec2 unit_w = w * (1.f / w_len);
      line.dir = Vec2(unit_w.y, -unit_w.x);
      u = (comb_r * inv_th - w_len) * unit_w;
    } else {
      float leg = std::sqrt(dist_sq - comb_r_sq);
      if (det(rel_pos, w) > 0.f) {
        line.dir = Vec2(rel_pos.x * leg - rel_pos.y * comb_r,
                        rel_pos.x * comb_r + rel_pos.y * leg) * (1.f / dist_sq);
      } else {
        line.dir = -(Vec2(rel_pos.x * leg + rel_pos.y * comb_r,
                          -rel_pos.x * comb_r + rel_pos.y * leg) *
                     (1.f / dist_sq));
      }
      u = dot(rel_vel, line.dir) * line.dir - rel_vel;
    }
  } else {
    float inv_dt = 1.f / dt;
    Vec2 w = rel_vel - inv_dt * rel_pos;
    float w_len = norm(w);
    Vec2 unit_w = w * (1.f / std::max(w_len, 1e-9f));
    line.dir = Vec2(unit_w.y, -unit_w.x);
    u = (comb_r * inv_dt - w_len) * unit_w;
  }
  line.point = vel + 0.5f * u;
  lines->push_back(line);
}

// One directed wall edge (standalone 2-vertex obstacle topology).
void add_obstacle_line(std::vector<Line>* lines, const Vec2& pos,
                       const Vec2& vel, float rad, const Vec2& p1,
                       const Vec2& p2, float inv_th) {
  Vec2 rp1 = p1 - pos;
  Vec2 rp2 = p2 - pos;
  Vec2 unit_dir = normalize(p2 - p1);
  float r_sq = rad * rad;

  // already-covered check against previously inserted obstacle lines
  for (const Line& l : *lines) {
    if (det(inv_th * rp1 - l.point, l.dir) - inv_th * rad >= -RVO_EPSILON &&
        det(inv_th * rp2 - l.point, l.dir) - inv_th * rad >= -RVO_EPSILON)
      return;
  }

  float d1_sq = abs_sq(rp1);
  float d2_sq = abs_sq(rp2);
  Vec2 ovec = p2 - p1;
  float s = dot(-rp1, ovec) / abs_sq(ovec);
  float dline_sq = abs_sq(-rp1 - s * ovec);

  Line line;
  if (s < 0.f && d1_sq <= r_sq) {
    line.point = Vec2();
    line.dir = normalize(Vec2(-rp1.y, rp1.x));
    lines->push_back(line);
    return;
  } else if (s > 1.f && d2_sq <= r_sq) {
    if (det(rp2, -unit_dir) >= 0.f) {
      line.point = Vec2();
      line.dir = normalize(Vec2(-rp2.y, rp2.x));
      lines->push_back(line);
    }
    return;
  } else if (s >= 0.f && s <= 1.f && dline_sq <= r_sq) {
    line.point = Vec2();
    line.dir = -unit_dir;
    lines->push_back(line);
    return;
  }

  Vec2 left_leg, right_leg, cut_l, cut_r;
  bool same_vertex = false;
  if (s < 0.f && dline_sq <= r_sq) {
    same_vertex = true;
    float leg1 = std::sqrt(d1_sq - r_sq);
    left_leg = Vec2(rp1.x * leg1 - rp1.y * rad, rp1.x * rad + rp1.y * leg1) *
               (1.f / d1_sq);
    right_leg = Vec2(rp1.x * leg1 + rp1.y * rad, -rp1.x * rad + rp1.y * leg1) *
                (1.f / d1_sq);
    cut_l = cut_r = rp1;
  } else if (s > 1.f && dline_sq <= r_sq) {
    same_vertex = true;
    float leg2 = std::sqrt(d2_sq - r_sq);
    left_leg = Vec2(rp2.x * leg2 - rp2.y * rad, rp2.x * rad + rp2.y * leg2) *
               (1.f / d2_sq);
    right_leg = Vec2(rp2.x * leg2 + rp2.y * rad, -rp2.x * rad + rp2.y * leg2) *
                (1.f / d2_sq);
    cut_l = cut_r = rp2;
  } else {
    float leg1 = std::sqrt(d1_sq - r_sq);
    left_leg = Vec2(rp1.x * leg1 - rp1.y * rad, rp1.x * rad + rp1.y * leg1) *
               (1.f / d1_sq);
    float leg2 = std::sqrt(d2_sq - r_sq);
    right_leg = Vec2(rp2.x * leg2 + rp2.y * rad, -rp2.x * rad + rp2.y * leg2) *
                (1.f / d2_sq);
    cut_l = rp1;
    cut_r = rp2;
  }

  bool left_foreign = false, right_foreign = false;
  if (det(left_leg, unit_dir) >= 0.f) {   // prev edge dir = -unit_dir
    left_leg = unit_dir;
    left_foreign = true;
  }
  if (det(right_leg, unit_dir) <= 0.f) {  // next edge dir = unit_dir
    right_leg = unit_dir;
    right_foreign = true;
  }

  Vec2 left_cut = inv_th * cut_l;
  Vec2 right_cut = inv_th * cut_r;
  Vec2 cut_vec = right_cut - left_cut;

  float t = same_vertex ? 0.5f
                        : dot(vel - left_cut, cut_vec) / abs_sq(cut_vec);
  float t_left = dot(vel - left_cut, left_leg);
  float t_right = dot(vel - right_cut, right_leg);

  if ((t < 0.f && t_left < 0.f) ||
      (same_vertex && t_left < 0.f && t_right < 0.f)) {
    Vec2 unit_w = normalize(vel - left_cut);
    line.dir = Vec2(unit_w.y, -unit_w.x);
    line.point = left_cut + rad * inv_th * unit_w;
    lines->push_back(line);
    return;
  } else if (t > 1.f && t_right < 0.f) {
    Vec2 unit_w = normalize(vel - right_cut);
    line.dir = Vec2(unit_w.y, -unit_w.x);
    line.point = right_cut + rad * inv_th * unit_w;
    lines->push_back(line);
    return;
  }

  float d_cut = (t < 0.f || t > 1.f || same_vertex)
                    ? 1e18f
                    : abs_sq(vel - (left_cut + t * cut_vec));
  float d_left = (t_left < 0.f) ? 1e18f
                                : abs_sq(vel - (left_cut + t_left * left_leg));
  float d_right =
      (t_right < 0.f) ? 1e18f
                      : abs_sq(vel - (right_cut + t_right * right_leg));

  if (d_cut <= d_left && d_cut <= d_right) {
    line.dir = -unit_dir;
    line.point = left_cut + rad * inv_th * Vec2(-line.dir.y, line.dir.x);
    lines->push_back(line);
  } else if (d_left <= d_right) {
    if (left_foreign) return;
    line.dir = left_leg;
    line.point = left_cut + rad * inv_th * Vec2(-line.dir.y, line.dir.x);
    lines->push_back(line);
  } else {
    if (right_foreign) return;
    line.dir = -right_leg;
    line.point = right_cut + rad * inv_th * Vec2(-line.dir.y, line.dir.x);
    lines->push_back(line);
  }
}

struct EdgeRef {
  float dist;
  Vec2 p1, p2;
};

}  // namespace

extern "C" {

// New velocities for n acting agents, each against all others + walls.
// pos/vel/pref_vel: n x 2; rad/max_speed: n; walls: w x 4 (x1,y1,x2,y2).
// out_vel: n x 2.
void orca_step(const float* pos, const float* vel, const float* rad,
               const float* pref_vel, const float* max_speed, int n_agents,
               const float* walls, int n_walls, float neighbor_dist,
               int max_neighbors, float time_horizon, float time_horizon_obst,
               float dt, float* out_vel) {
  for (int a = 0; a < n_agents; ++a) {
    Vec2 p(pos[2 * a], pos[2 * a + 1]);
    Vec2 v(vel[2 * a], vel[2 * a + 1]);
    Vec2 pv(pref_vel[2 * a], pref_vel[2 * a + 1]);
    float r = rad[a];
    float ms = max_speed[a];

    // obstacle edges: visible orientation only, nearest-first
    std::vector<EdgeRef> edges;
    float range = time_horizon_obst * ms + r;
    for (int w = 0; w < n_walls; ++w) {
      Vec2 w1(walls[4 * w], walls[4 * w + 1]);
      Vec2 w2(walls[4 * w + 2], walls[4 * w + 3]);
      for (int o = 0; o < 2; ++o) {
        Vec2 p1 = o ? w2 : w1;
        Vec2 p2 = o ? w1 : w2;
        if (det(p2 - p1, p - p1) >= 0.f) continue;  // wrong side
        Vec2 d = p2 - p1;
        float dd = std::max(abs_sq(d), 1e-18f);
        float u = std::min(std::max(dot(p - p1, d) / dd, 0.f), 1.f);
        float dist = norm(p1 + u * d - p);
        if (dist < range) edges.push_back({dist, p1, p2});
      }
    }
    std::stable_sort(edges.begin(), edges.end(),
                     [](const EdgeRef& x, const EdgeRef& y) {
                       return x.dist < y.dist;
                     });

    std::vector<Line> lines;
    float inv_tho = 1.f / time_horizon_obst;
    for (const EdgeRef& e : edges)
      add_obstacle_line(&lines, p, v, r, e.p1, e.p2, inv_tho);
    size_t num_obst = lines.size();

    // neighbor agents, nearest-first, capped
    std::vector<std::pair<float, int>> neigh;
    for (int b = 0; b < n_agents; ++b) {
      if (b == a) continue;
      float d = norm(Vec2(pos[2 * b], pos[2 * b + 1]) - p);
      if (d < neighbor_dist) neigh.push_back({d, b});
    }
    std::stable_sort(neigh.begin(), neigh.end());
    if ((int)neigh.size() > max_neighbors) neigh.resize(max_neighbors);
    for (auto& nb : neigh) {
      int b = nb.second;
      add_agent_line(&lines, p, v, r, Vec2(pos[2 * b], pos[2 * b + 1]),
                     Vec2(vel[2 * b], vel[2 * b + 1]), rad[b], time_horizon,
                     dt);
    }

    Vec2 result;
    size_t fail = linear_program2(lines, ms, pv, false, &result);
    if (fail < lines.size())
      linear_program3(lines, num_obst, fail, ms, &result);
    out_vel[2 * a] = result.x;
    out_vel[2 * a + 1] = result.y;
  }
}

}  // extern "C"
