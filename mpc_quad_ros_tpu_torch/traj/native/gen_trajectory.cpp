// gen_trajectory — CLI with the reference genTrajectory's flag contract:
//
//   gen_trajectory -i waypoints.csv -o polynomial.csv --v_max V --a_max A
//
// waypoints.csv: one "x,y,z" row per waypoint (no header).
// output: the 33-column piecewise-polynomial CSV (duration, x^0..x^7,
// y^0..y^7, z^0..z^7, yaw^0..yaw^7) consumed by uav_trajectory.Trajectory /
// PiecewisePolynomial4D.loadcsv.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" int minsnap_solve(const double* waypoints, int n_wp, double v_max,
                             double a_max, int max_scaling_iters,
                             double* out_durations, double* out_coeffs);

int main(int argc, char** argv) {
  std::string in_path, out_path;
  double v_max = -1.0, a_max = -1.0;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&](const char* flag) -> const char* {
      if (i + 1 >= argc) { std::fprintf(stderr, "missing value for %s\n", flag); std::exit(2); }
      return argv[++i];
    };
    if (a == "-i" || a == "--input") in_path = next("-i");
    else if (a == "-o" || a == "--output") out_path = next("-o");
    else if (a == "--v_max") v_max = std::atof(next("--v_max"));
    else if (a == "--a_max") a_max = std::atof(next("--a_max"));
    else if (a == "-h" || a == "--help") {
      std::printf("usage: gen_trajectory -i waypoints.csv -o poly.csv --v_max V --a_max A\n");
      return 0;
    } else {
      std::fprintf(stderr, "unknown argument: %s\n", a.c_str());
      return 2;
    }
  }
  if (in_path.empty() || out_path.empty() || v_max <= 0 || a_max <= 0) {
    std::fprintf(stderr, "usage: gen_trajectory -i waypoints.csv -o poly.csv --v_max V --a_max A\n");
    return 2;
  }

  std::vector<double> wp;
  {
    FILE* f = std::fopen(in_path.c_str(), "r");
    if (!f) { std::fprintf(stderr, "cannot open %s\n", in_path.c_str()); return 1; }
    char line[4096];
    while (std::fgets(line, sizeof(line), f)) {
      if (line[0] == '#' || line[0] == '\n') continue;
      double x, y, z;
      if (std::sscanf(line, "%lf,%lf,%lf", &x, &y, &z) == 3 ||
          std::sscanf(line, "%lf %lf %lf", &x, &y, &z) == 3) {
        wp.push_back(x); wp.push_back(y); wp.push_back(z);
      }
    }
    std::fclose(f);
  }
  const int n_wp = static_cast<int>(wp.size() / 3);
  if (n_wp < 2) { std::fprintf(stderr, "need at least 2 waypoints, got %d\n", n_wp); return 1; }

  const int K = n_wp - 1;
  std::vector<double> durations(K), coeffs(static_cast<size_t>(K) * 4 * 8);
  const int rc = minsnap_solve(wp.data(), n_wp, v_max, a_max, 12,
                               durations.data(), coeffs.data());
  if (rc != 0) { std::fprintf(stderr, "minsnap_solve failed (%d)\n", rc); return 1; }

  FILE* f = std::fopen(out_path.c_str(), "w");
  if (!f) { std::fprintf(stderr, "cannot open %s for writing\n", out_path.c_str()); return 1; }
  std::fprintf(f, "# duration");
  const char* axes[4] = {"x", "y", "z", "yaw"};
  for (int ax = 0; ax < 4; ++ax)
    for (int k = 0; k < 8; ++k) std::fprintf(f, ",%s^%d", axes[ax], k);
  std::fprintf(f, "\n");
  for (int j = 0; j < K; ++j) {
    std::fprintf(f, "%.6f", durations[j]);
    for (int c = 0; c < 32; ++c) std::fprintf(f, ",%.6f", coeffs[j * 32 + c]);
    std::fprintf(f, "\n");
  }
  std::fclose(f);
  return 0;
}
