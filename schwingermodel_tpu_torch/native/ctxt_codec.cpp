// Native codec for the reference gauge-configuration formats.
//
// Byte-compatible with Fabian2598/SchwingerModel's binary .ctxt writer
// (src/gauge_conf.cpp:404-419): a stream of 28-byte records
//   int32 x, int32 t, int32 mu, float64 re, float64 im
// ordered x-major, then t, then mu (0=time direction, 1=space direction),
// and with its whitespace text form (readBinConf.cpp:104-131 /
// read_conf, src/gauge_conf.cpp:453-492).
//
// The in-memory layout is interleaved re/im doubles in [mu][x][t] C order:
//   buf[((mu*Nx + x)*Nt + t)*2 + 0] = Re U_mu(x,t)
//   buf[((mu*Nx + x)*Nt + t)*2 + 1] = Im U_mu(x,t)
//
// Exposed as a plain C ABI for ctypes. Returns 0 on success, negative
// error codes otherwise: config snapshot encode/decode runs on the host
// while the card computes. The PyTorch port's own copy of
// schwingermodel_tpu/native/ctxt_codec.cpp, built by
// schwingermodel_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

#pragma pack(push, 1)
struct Record {
    int32_t x;
    int32_t t;
    int32_t mu;
    double re;
    double im;
};
#pragma pack(pop)

static_assert(sizeof(Record) == 28, "record must be 28 bytes, packed");

inline size_t site_index(int mu, int x, int t, int Nx, int Nt) {
    return ((static_cast<size_t>(mu) * Nx + x) * Nt + t) * 2;
}

}  // namespace

extern "C" {

// ---------- binary ----------

int ctxt_write_binary(const char* path, const double* buf, int Nx, int Nt) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::vector<Record> recs;
    recs.reserve(static_cast<size_t>(Nx) * Nt * 2);
    for (int x = 0; x < Nx; ++x)
        for (int t = 0; t < Nt; ++t)
            for (int mu = 0; mu < 2; ++mu) {
                size_t i = site_index(mu, x, t, Nx, Nt);
                recs.push_back(Record{x, t, mu, buf[i], buf[i + 1]});
            }
    size_t n = std::fwrite(recs.data(), sizeof(Record), recs.size(), f);
    std::fclose(f);
    return n == recs.size() ? 0 : -2;
}

int ctxt_read_binary(const char* path, double* buf, int Nx, int Nt) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    const size_t nrec = static_cast<size_t>(Nx) * Nt * 2;
    std::vector<Record> recs(nrec);
    size_t n = std::fread(recs.data(), sizeof(Record), nrec, f);
    std::fclose(f);
    if (n != nrec) return -2;
    for (const Record& r : recs) {
        if (r.x < 0 || r.x >= Nx || r.t < 0 || r.t >= Nt || r.mu < 0 || r.mu > 1)
            return -3;  // corrupt or wrong-shape file
        size_t i = site_index(r.mu, r.x, r.t, Nx, Nt);
        buf[i] = r.re;
        buf[i + 1] = r.im;
    }
    return 0;
}

// ---------- text ----------

int ctxt_write_text(const char* path, const double* buf, int Nx, int Nt) {
    FILE* f = std::fopen(path, "w");
    if (!f) return -1;
    for (int x = 0; x < Nx; ++x)
        for (int t = 0; t < Nt; ++t)
            for (int mu = 0; mu < 2; ++mu) {
                size_t i = site_index(mu, x, t, Nx, Nt);
                // 17 significant digits round-trips an IEEE double exactly
                if (std::fprintf(f, "%d %d %d %.17g %.17g\n", x, t, mu,
                                 buf[i], buf[i + 1]) < 0) {
                    std::fclose(f);
                    return -2;
                }
            }
    std::fclose(f);
    return 0;
}

int ctxt_read_text(const char* path, double* buf, int Nx, int Nt) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    int x, t, mu;
    double re, im;
    size_t seen = 0;
    while (std::fscanf(f, "%d %d %d %lf %lf", &x, &t, &mu, &re, &im) == 5) {
        if (x < 0 || x >= Nx || t < 0 || t >= Nt || mu < 0 || mu > 1) {
            std::fclose(f);
            return -3;
        }
        size_t i = site_index(mu, x, t, Nx, Nt);
        buf[i] = re;
        buf[i + 1] = im;
        ++seen;
    }
    std::fclose(f);
    return seen == static_cast<size_t>(Nx) * Nt * 2 ? 0 : -2;
}

}  // extern "C"
