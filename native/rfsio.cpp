// rfsio — native IO runtime for the rfs_slam_tpu framework.
//
// The reference library's logging/ingest tier is C++ (fprintf/fscanf loops in
// the apps, e.g. rbphdslam2dSim.cpp:369-441 writers and
// rbphdslam_VictoriaPark.cpp:199-324 dataset readers).  This module provides
// the same native-performance tier for this package: reference-format .dat
// writers (the Python fallback formats ~600k rows per sim run at interpreter
// speed) and a bulk whitespace-delimited text parser for dataset ingest.
// Bound to Python via ctypes (see rfs_slam_tpu/io/native.py).
//
// Build: make -C native rfsio  (produces librfsio.so)

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// particlePose.dat: initial t=0 block with weight 1.0, then per step
// "t i x y theta w" rows + blank separator (rbphdslam2dSim.cpp:609-632).
int rfsio_write_particle_poses(const char* path, const double* times,
                               const double* poses,   // [T, P, 3]
                               const double* weights,  // [T, P]
                               long T, long P) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  for (long i = 0; i < P; i++)
    fprintf(f, "%f   %ld   %f   %f   %f   1.0\n", 0.0, i, 0.0, 0.0, 0.0);
  for (long k = 0; k < T; k++) {
    const double* pk = poses + k * P * 3;
    const double* wk = weights + k * P;
    for (long i = 0; i < P; i++) {
      fprintf(f, "%f   %ld   %f   %f   %f   %f\n", times[k], i,
              pk[i * 3], pk[i * 3 + 1], pk[i * 3 + 2], wk[i]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

// landmarkEst.dat: "t i x y Sxx Sxy Syy w" rows for alive landmarks of the
// best particle per step (rbphdslam2dSim.cpp:634-641).
int rfsio_write_landmark_estimates(const char* path, const double* times,
                                   const long* best,      // [T]
                                   const double* means,   // [T, M, 2]
                                   const double* covs,    // [T, M, 3] packed
                                   const double* ws,      // [T, M]
                                   const unsigned char* alive,  // [T, M]
                                   long T, long M) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  for (long k = 0; k < T; k++) {
    const double* mk = means + k * M * 2;
    const double* ck = covs + k * M * 3;
    const double* wk = ws + k * M;
    const unsigned char* ak = alive + k * M;
    for (long m = 0; m < M; m++) {
      if (!ak[m]) continue;
      fprintf(f, "%f   %ld   %f   %f      %f   %f   %f   %f\n", times[k],
              best[k], mk[m * 2], mk[m * 2 + 1], ck[m * 3], ck[m * 3 + 1],
              ck[m * 3 + 2], wk[m]);
    }
  }
  fclose(f);
  return 0;
}

// Bulk parse of a whitespace/newline-delimited numeric text file.
// Returns the number of values parsed into out (up to cap), or -1 on error.
// Pass cap=0 / out=NULL to count only.
long rfsio_read_values(const char* path, double* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(size + 1);
  if (!buf) { fclose(f); return -1; }
  long rd = (long)fread(buf, 1, size, f);
  fclose(f);
  buf[rd] = '\0';

  long n = 0;
  const char* p = buf;
  char* end;
  for (;;) {
    double v = strtod(p, &end);
    if (end == p) {
      // skip one non-numeric char (commas, stray text) or finish
      if (*p == '\0') break;
      p++;
      continue;
    }
    if (out && n < cap) out[n] = v;
    n++;
    p = end;
  }
  free(buf);
  return n;
}

}  // extern "C"
