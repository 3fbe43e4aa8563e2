// Native opacity-database ingest for picaso_tpu_torch (copy of
// picaso_tpu/native/fastload.cpp; keep the two in step).
//
// The reference loads molecular opacities by decoding one numpy .npy BLOB
// per (molecule, PT-point) row through Python sqlite3 + np.load
// (optics.py:1985-1996, :2126-2239) — for a full 1060/1460-point database
// that is thousands of interpreter round-trips plus a single-threaded
// log10 over the whole cube, and it dominates framework cold-start.  This
// C++ path does the same ingest with one sqlite connection per molecule
// thread, zero-copy BLOB access, and the resample/window/log10 fused into
// the row decode.
//
// Built on demand by picaso_tpu_torch.native (g++ -O3 -shared) into the
// package's build directory, linked against the system libsqlite3.  The
// sqlite3 C API subset used here is declared locally (a machine may have
// the shared library without the dev header).
//
// Exposed C ABI:
//   fastload_molecular(db, mols, nmol, npt, loc, nloc, resample, out)
//     -> fills out[nmol, npt, nloc] (float32) with
//        log10(max(opacity, 1e-50)); rows absent from the DB stay at the
//        caller's fill value.  Returns 0 on success.
//   fastload_continuum(db, mols, nmol, temps, ntemp, loc, nloc, resample,
//                      out) -> out[nmol, ntemp, nloc] raw float32 values.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// ---- minimal sqlite3 C API (stable ABI; header not shipped in image) ----
extern "C" {
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
int sqlite3_open_v2(const char*, sqlite3**, int, const char*);
int sqlite3_prepare_v2(sqlite3*, const char*, int, sqlite3_stmt**,
                       const char**);
int sqlite3_bind_text(sqlite3_stmt*, int, const char*, int, void (*)(void*));
int sqlite3_step(sqlite3_stmt*);
int sqlite3_column_int(sqlite3_stmt*, int);
double sqlite3_column_double(sqlite3_stmt*, int);
const void* sqlite3_column_blob(sqlite3_stmt*, int);
int sqlite3_column_bytes(sqlite3_stmt*, int);
int sqlite3_finalize(sqlite3_stmt*);
int sqlite3_close(sqlite3*);
}
#define SQLITE_OK 0
#define SQLITE_ROW 100
#define SQLITE_OPEN_READONLY 0x00000001
#define SQLITE_OPEN_NOMUTEX 0x00008000
#define SQLITE_STATIC ((void (*)(void*))0)

namespace {

// Parse a .npy v1/v2 header; return pointer to the float64 payload and its
// element count, or nullptr on anything unexpected (caller falls back).
const double* npy_f8_payload(const unsigned char* blob, int nbytes,
                             int64_t* count) {
  if (nbytes < 10 || std::memcmp(blob, "\x93NUMPY", 6) != 0) return nullptr;
  const int major = blob[6];
  uint32_t hlen;
  int64_t off;
  if (major == 1) {
    hlen = blob[8] | (blob[9] << 8);
    off = 10;
  } else {
    if (nbytes < 12) return nullptr;
    hlen = blob[8] | (blob[9] << 8) | (blob[10] << 16) |
           (uint32_t(blob[11]) << 24);
    off = 12;
  }
  if (off + int64_t(hlen) > nbytes) return nullptr;
  std::string header(reinterpret_cast<const char*>(blob + off), hlen);
  if (header.find("'<f8'") == std::string::npos &&
      header.find("\"<f8\"") == std::string::npos)
    return nullptr;                      // only little-endian float64 blobs
  if (header.find("True") != std::string::npos) return nullptr;  // fortran
  const int64_t data_off = off + hlen;
  *count = (nbytes - data_off) / 8;
  return reinterpret_cast<const double*>(blob + data_off);
}

struct MolTask {
  const char* db_path;
  const char* molecule;
  const int64_t* loc;   // window indices into the resampled grid
  int64_t nloc;
  int64_t resample;
  int64_t npt;
  float* out;           // [npt, nloc] slab for this molecule
};

int load_one_molecule(const MolTask& t) {
  sqlite3* db = nullptr;
  if (sqlite3_open_v2(t.db_path, &db,
                      SQLITE_OPEN_READONLY | SQLITE_OPEN_NOMUTEX,
                      nullptr) != SQLITE_OK)
    return 1;
  sqlite3_stmt* st = nullptr;
  const char* sql =
      "SELECT ptid, opacity FROM molecular WHERE molecule = ?";
  if (sqlite3_prepare_v2(db, sql, -1, &st, nullptr) != SQLITE_OK) {
    sqlite3_close(db);
    return 2;
  }
  sqlite3_bind_text(st, 1, t.molecule, -1, SQLITE_STATIC);
  int rc = 0;
  while (sqlite3_step(st) == SQLITE_ROW) {
    const int64_t ptid = sqlite3_column_int(st, 0);
    if (ptid < 1 || ptid > t.npt) continue;
    const unsigned char* blob =
        static_cast<const unsigned char*>(sqlite3_column_blob(st, 1));
    const int nbytes = sqlite3_column_bytes(st, 1);
    int64_t count = 0;
    const double* data = npy_f8_payload(blob, nbytes, &count);
    if (data == nullptr) {
      rc = 3;
      break;
    }
    if (t.nloc <= 0) continue;
    float* row = t.out + (ptid - 1) * t.nloc;
    // loc is sorted ascending (np.where/arange output), so the last
    // element bounds every gather
    if (t.loc[t.nloc - 1] * t.resample >= count) {
      rc = 4;
      break;
    }
    // zeros -> 1e-50 before the log, exactly like the Python loader
    // (db.py; reference optics.py:2282-2289 uses the same guard).
    // Built without -ffast-math: log10 stays the libm call, so each value
    // is bitwise the Python decode's (np.log10 in float64, then float32).
#pragma omp simd
    for (int64_t j = 0; j < t.nloc; ++j) {
      const double v = data[t.loc[j] * t.resample];
      row[j] = float(std::log10(v != 0.0 ? v : 1e-50));
    }
  }
  sqlite3_finalize(st);
  sqlite3_close(db);
  return rc;
}

}  // namespace

extern "C" {

int fastload_molecular(const char* db_path, const char** molecules,
                       int64_t nmol, int64_t npt, const int64_t* loc,
                       int64_t nloc, int64_t resample, float* out) {
  std::atomic<int> err{0};
  std::atomic<int64_t> next{0};
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t nthreads =
      std::min<int64_t>(nmol, hw > 2 ? hw - 1 : 1);
  std::vector<std::thread> pool;
  for (int64_t w = 0; w < nthreads; ++w) {
    pool.emplace_back([&]() {
      for (;;) {
        const int64_t im = next.fetch_add(1);
        if (im >= nmol || err.load()) return;
        MolTask t{db_path, molecules[im], loc, nloc, resample, npt,
                  out + im * npt * nloc};
        const int rc = load_one_molecule(t);
        if (rc) err.store(rc);
      }
    });
  }
  for (auto& th : pool) th.join();
  return err.load();
}

int fastload_continuum(const char* db_path, const char** molecules,
                       int64_t nmol, const double* temps, int64_t ntemp,
                       const int64_t* loc, int64_t nloc, int64_t resample,
                       float* out) {
  sqlite3* db = nullptr;
  if (sqlite3_open_v2(db_path, &db, SQLITE_OPEN_READONLY, nullptr) !=
      SQLITE_OK)
    return 1;
  sqlite3_stmt* st = nullptr;
  const char* sql =
      "SELECT temperature, opacity FROM continuum WHERE molecule = ?";
  int rc = 0;
  for (int64_t im = 0; im < nmol && rc == 0; ++im) {
    if (sqlite3_prepare_v2(db, sql, -1, &st, nullptr) != SQLITE_OK) {
      rc = 2;
      break;
    }
    sqlite3_bind_text(st, 1, molecules[im], -1, SQLITE_STATIC);
    while (sqlite3_step(st) == SQLITE_ROW) {
      const double tval = sqlite3_column_double(st, 0);
      // nearest temperature row (temps is sorted ascending, exact in
      // practice — mirrors np.searchsorted in the Python loader)
      int64_t it = 0;
      double best = 1e300;
      for (int64_t k = 0; k < ntemp; ++k) {
        const double d = std::abs(temps[k] - tval);
        if (d < best) {
          best = d;
          it = k;
        }
      }
      const unsigned char* blob =
          static_cast<const unsigned char*>(sqlite3_column_blob(st, 1));
      int64_t count = 0;
      const double* data = npy_f8_payload(blob, sqlite3_column_bytes(st, 1),
                                          &count);
      if (data == nullptr) {
        rc = 3;
        break;
      }
      float* row = out + (im * ntemp + it) * nloc;
      for (int64_t j = 0; j < nloc; ++j) {
        const int64_t src = loc[j] * resample;
        if (src >= count) {
          rc = 4;
          break;
        }
        row[j] = float(data[src]);
      }
      if (rc) break;
    }
    sqlite3_finalize(st);
    st = nullptr;
  }
  sqlite3_close(db);
  return rc;
}

}  // extern "C"
