// Native CIGAR finalization: banded global alignment + traceback +
// band-retry loop + NM/MD, batched over the output records of a read
// batch.
//
// Host-side counterpart of the reference's CIGAR path: ksw_global2
// (reference: src/ksw.cpp:558-672) driven by bwa_gen_cigar2
// (src/bwa.cpp:380-470) under mem_reg2aln's band-doubling retry
// (src/bwamem.cpp:2533-2624). Semantics are ported from the tested
// Python oracle (bwa_mem_scale_tpu/ref/ksw.py) bit-for-bit; the device
// build keeps CIGARs on the host because each job is a tiny
// (<=len x band) DP — microseconds in native code — while a device
// round trip costs milliseconds of queue serialization.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libkswg.so kswg.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "kswg_core.h"
using kswg_core::ksw_global;
using kswg_core::nm_md;

extern "C" {

// Finalize a batch of output records: per job run the bwa_gen_cigar2
// band selection + mem_reg2aln retry loop (or the gap-free shortcut),
// then NM/MD. Sequences are nt4 codes (0-4), rc-strand jobs already
// reversed by the caller. Returns 0, or the 1-based index of the
// first job whose cigar overflowed cig_stride (nothing written for it).
int64_t kswg_finalize_batch(
    int64_t n,
    const uint8_t* qbuf, const int64_t* qoff, const int32_t* qlen,
    const uint8_t* tbuf, const int64_t* toff, const int32_t* tlen,
    const int32_t* w2_in, const int32_t* truesc, const uint8_t* is_fw,
    const int8_t* mat, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t a, int32_t maxw,
    int32_t* score_out, uint32_t* cig_out, int32_t* ncig_out,
    int32_t cig_stride, int32_t* nm_out, char* md_out,
    int32_t* mdlen_out, int32_t md_stride) {
    std::vector<uint32_t> cig;
    std::vector<uint8_t> zbuf;
    std::vector<int32_t> Hbuf, Ebuf;
    for (int64_t j = 0; j < n; ++j) {
        const uint8_t* q = qbuf + qoff[j];
        const uint8_t* t = tbuf + toff[j];
        const int lq = qlen[j], lt = tlen[j];
        int w2 = std::min(w2_in[j], maxw);
        int32_t last_sc = -(1 << 30);
        int rounds = 0;
        int32_t score = 0;
        while (true) {
            if (lq == lt && w2 == 0) {
                // gap-free shortcut (src/bwa.cpp:404-414)
                cig.clear();
                cig.push_back(((uint32_t)lq << 4) | 0);
                score = 0;
                for (int i = 0; i < lq; ++i)
                    score += mat[t[i] * 5 + q[i]];
            } else {
                // band selection (bwa_gen_cigar2)
                const int m00 = mat[0];
                const int max_ins = (int)((((lq + 1) >> 1) * (double)m00
                                           - o_ins) / e_ins + 1.0);
                const int max_del = (int)((((lq + 1) >> 1) * (double)m00
                                           - o_del) / e_del + 1.0);
                const int max_gap = std::max(std::max(max_ins, max_del), 1);
                int w = (max_gap + std::abs(lt - lq) + 1) >> 1;
                w = std::min(w, w2);
                w = std::max(w, std::abs(lt - lq) + 3);
                score = ksw_global(lq, q, lt, t, mat, o_del, e_del,
                                   o_ins, e_ins, w, &cig, zbuf, Hbuf,
                                   Ebuf);
            }
            if (score == last_sc || w2 == maxw) break;
            last_sc = score;
            w2 <<= 1;
            ++rounds;
            if (!(rounds < 4 && score < truesc[j] - a)) break;
            w2 = std::min(w2, maxw);
        }
        if ((int32_t)cig.size() > cig_stride) return j + 1;
        score_out[j] = score;
        ncig_out[j] = (int32_t)cig.size();
        std::memcpy(cig_out + (size_t)j * cig_stride, cig.data(),
                    cig.size() * sizeof(uint32_t));
        nm_md(cig.data(), (int)cig.size(), q, t, is_fw[j], nm_out + j,
              md_out + (size_t)j * md_stride, md_stride, mdlen_out + j);
    }
    return 0;
}

}  // extern "C"
