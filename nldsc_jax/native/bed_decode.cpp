// Native PLINK .bed block decoder (host IO hot path).
//
// The reference streams one SNP at a time through a buffered ifstream with a
// per-genotype switch (reference stream.h:43-69, encoder.h:19-40).  This
// decoder is block-oriented and parallel: each OpenMP thread preads its
// SNPs' contiguous byte range and expands bytes through a 256x4 lookup
// table into int8 additive codes {0,1,2,-1} (low-to-high bitpair order per
// the PLINK spec; sample order is statistics-invariant, SURVEY Q7).
//
// C ABI only — loaded via ctypes (no pybind11 in this toolchain).
//
// Build: make -C nldsc_jax/native   (or scripts/build_native.sh)

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Lut {
    int8_t row[256][4];
    Lut() {
        // 2-bit PLINK code -> additive genotype (counting A2 alleles)
        static const int8_t code_map[4] = {0, -1, 1, 2};
        for (int byte = 0; byte < 256; ++byte)
            for (int k = 0; k < 4; ++k)
                row[byte][k] = code_map[(byte >> (2 * k)) & 0x3];
    }
};
const Lut kLut;

}  // namespace

extern "C" {

// Decode SNPs [start, start+count) of a .bed file into out[count][n_samples].
// Returns 0 on success, negative errno-style codes on failure.
int bed_decode_range(const char* path, int64_t n_samples,
                     int64_t bytes_per_snp, int64_t start, int64_t count,
                     int8_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;

    // magic check (3-byte header, PLINK SNP-major)
    unsigned char magic[3];
    if (pread(fd, magic, 3, 0) != 3 ||
        magic[0] != 0x6c || magic[1] != 0x1b || magic[2] != 0x01) {
        close(fd);
        return -2;
    }

    const int64_t full_bytes = n_samples / 4;
    const int64_t tail = n_samples % 4;
    int status = 0;

#pragma omp parallel
    {
        unsigned char* buf = new unsigned char[bytes_per_snp];
#pragma omp for schedule(static)
        for (int64_t i = 0; i < count; ++i) {
            const int64_t off = 3 + (start + i) * bytes_per_snp;
            if (pread(fd, buf, bytes_per_snp, off) != bytes_per_snp) {
#pragma omp atomic write
                status = -3;
                continue;
            }
            int8_t* dst = out + i * n_samples;
            for (int64_t j = 0; j < full_bytes; ++j)
                std::memcpy(dst + 4 * j, kLut.row[buf[j]], 4);
            for (int64_t k = 0; k < tail; ++k)
                dst[4 * full_bytes + k] = kLut.row[buf[full_bytes]][k];
        }
        delete[] buf;
    }

    close(fd);
    return status;
}

}  // extern "C"
