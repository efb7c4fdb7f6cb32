// Native SE finalization: device region rows -> finished SAM records.
//
// Host-side counterpart of the reference's per-read output pipeline:
// mem_sort_dedup_patch (src/bwamem.cpp:314-375) + mem_patch_reg
// (:200-250), mem_mark_primary_se (:1933-1977), mem_gen_alt
// (src/bwamem_extra.cpp:130-183), the mem_reg2sam selection loop
// (:2092-2130) and mem_reg2aln (:2533-2624) with bwa_gen_cigar2 /
// ksw_global2 (src/bwa.cpp:380-470). Semantics are ported bit-for-bit
// from the tested Python oracle (bwa_mem_scale_tpu/ref/finalize.py,
// pipeline/finalize.py) — the Python path stays as the differential
// oracle and fallback. The device build keeps this stage on the host
// because it is object-/string-shaped work the reference also runs
// native; at bench scale the Python loop was ~60% of end-to-end wall
// on this one-core box.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfinalize.so finalize.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "kswg_core.h"

namespace {

using kswg_core::ksw_global;
using kswg_core::nm_md;

constexpr double PATCH_MAX_R_BW = 0.05;
constexpr double PATCH_MIN_SC_RATIO = 0.90;
constexpr double MEM_MAPQ_COEF = 30.0;
constexpr int32_t MEM_F_ALL = 0x8;
constexpr int32_t MEM_F_NO_MULTI = 0x10;
constexpr int32_t MEM_F_PRIMARY5 = 0x800;
constexpr int32_t MEM_F_KEEP_SUPP_MAPQ = 0x1000;
constexpr int32_t SEC_ALT = 0x7FFFFFFF;  // (1 << 31) - 1

struct Opt {
    int32_t a, b, o_del, e_del, o_ins, e_ins, w, T;
    int32_t min_seed_len, max_chain_gap;
    double mask_level, drop_ratio, XA_drop_ratio, mask_level_redun;
    int32_t max_XA_hits, max_XA_hits_alt;
    int32_t mapQ_coef_len;
    double mapQ_coef_fac;
    int32_t flag;
    int8_t mat[25];
};

struct Bns {
    const int64_t* ann_off;   // [n_seqs]
    const int64_t* ann_len;   // [n_seqs]
    const uint8_t* is_alt;    // [n_seqs]
    const char* names;        // concatenated, NUL separated
    const int64_t* name_off;  // [n_seqs]
    int64_t n_seqs;
    int64_t l_pac;
};

struct Reg {
    int64_t rb, re;
    int32_t qb, qe, rid, score, truesc, w, seedcov, seedlen0;
    int32_t sub = 0, alt_sc = 0, csub = 0, sub_n = 0;
    int32_t secondary = -1, secondary_all = -1, n_comp = 1;
    bool is_alt = false;
    double frac_rep = 0.0;
    uint64_t hash = 0;
};

uint64_t hash_64(uint64_t key) {
    // Thomas Wang mix (reference src/utils.h:117-128)
    key = key + ~(key << 32);
    key ^= key >> 22;
    key = key + ~(key << 13);
    key ^= key >> 8;
    key = key + (key << 3);
    key ^= key >> 15;
    key = key + ~(key << 27);
    key ^= key >> 31;
    return key;
}

// ---- gen_cigar score-only (patch_reg's probe; ref/ksw.py gen_cigar) ----
int32_t gen_cigar_score_w(const Opt& opt, int w2, int64_t l_pac,
                          const uint8_t* ref_string, const uint8_t* query,
                          int l_query, int64_t rb, int64_t re,
                          std::vector<uint8_t>& qtmp,
                          std::vector<uint8_t>& ttmp,
                          std::vector<uint8_t>& zbuf,
                          std::vector<int32_t>& Hbuf,
                          std::vector<int32_t>& Ebuf) {
    if (l_query <= 0 || rb >= re || (rb < l_pac && re > l_pac)) return 0;
    const int rlen = (int)(re - rb);
    qtmp.assign(query, query + l_query);
    ttmp.assign(ref_string + rb, ref_string + re);
    if (rb >= l_pac) {
        std::reverse(qtmp.begin(), qtmp.end());
        std::reverse(ttmp.begin(), ttmp.end());
    }
    if (l_query == rlen && w2 == 0) {
        int32_t sc = 0;
        for (int i = 0; i < l_query; ++i)
            sc += opt.mat[ttmp[i] * 5 + qtmp[i]];
        return sc;
    }
    const int m00 = opt.mat[0];
    const int max_ins = (int)((((l_query + 1) >> 1) * (double)m00
                               - opt.o_ins) / opt.e_ins + 1.0);
    const int max_del = (int)((((l_query + 1) >> 1) * (double)m00
                               - opt.o_del) / opt.e_del + 1.0);
    const int max_gap = std::max(std::max(max_ins, max_del), 1);
    int w = (max_gap + std::abs(rlen - l_query) + 1) >> 1;
    w = std::min(w, w2);
    w = std::max(w, std::abs(rlen - l_query) + 3);
    return ksw_global(l_query, qtmp.data(), rlen, ttmp.data(), opt.mat,
                      opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w,
                      nullptr, zbuf, Hbuf, Ebuf);
}

// ---- patch_reg (ref/finalize.py:44-70, mem_patch_reg) ----
struct PatchRes { int32_t score, w; };
PatchRes patch_reg(const Opt& opt, const Bns& bns,
                   const uint8_t* ref_string, const uint8_t* query,
                   const Reg& a, const Reg& b,
                   std::vector<uint8_t>& qtmp, std::vector<uint8_t>& ttmp,
                   std::vector<uint8_t>& zbuf, std::vector<int32_t>& Hbuf,
                   std::vector<int32_t>& Ebuf) {
    if (a.rb < bns.l_pac && b.rb >= bns.l_pac) return {0, 0};
    if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return {0, 0};
    int64_t w64 = std::llabs((a.re - b.rb) - (int64_t)(a.qe - b.qb));
    double r = std::fabs((double)(a.re - b.rb) / (double)(b.re - a.rb)
                         - (double)(a.qe - b.qb) / (double)(b.qe - a.qb));
    if (a.re < b.rb || a.qe < b.qb) {
        if (w64 > (opt.w << 1) || r >= PATCH_MAX_R_BW) return {0, 0};
    } else if (w64 > (opt.w << 2) || r >= PATCH_MAX_R_BW * 2) {
        return {0, 0};
    }
    int w = (int)w64 + a.w + b.w;
    w = std::min(w, opt.w << 2);
    int32_t score = gen_cigar_score_w(opt, w, bns.l_pac, ref_string,
                                      query + a.qb, b.qe - a.qb, a.rb,
                                      b.re, qtmp, ttmp, zbuf, Hbuf, Ebuf);
    int32_t q_s = (int32_t)((double)(b.qe - a.qb)
                            / ((b.qe - b.qb) + (a.qe - a.qb))
                            * (b.score + a.score) + 0.499);
    int32_t r_s = (int32_t)((double)(b.re - a.rb)
                            / ((b.re - b.rb) + (a.re - a.rb))
                            * (b.score + a.score) + 0.499);
    if ((double)score / std::max(q_s, r_s) < PATCH_MIN_SC_RATIO)
        return {0, 0};
    return {score, w};
}

// ---- sort_dedup_patch (ref/finalize.py:73-123, mem_sort_dedup_patch) --
void sort_dedup_patch(const Opt& opt, const Bns& bns,
                      const uint8_t* ref_string, const uint8_t* query,
                      std::vector<Reg>& regs, std::vector<uint8_t>& qtmp,
                      std::vector<uint8_t>& ttmp, std::vector<uint8_t>& zbuf,
                      std::vector<int32_t>& Hbuf, std::vector<int32_t>& Ebuf) {
    const size_t n = regs.size();
    if (n <= 1) return;
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg& x, const Reg& y) { return x.re < y.re; });
    for (auto& r : regs) r.n_comp = 1;
    for (size_t i = 1; i < n; ++i) {
        Reg& p = regs[i];
        if (p.rid != regs[i - 1].rid
            || p.rb >= regs[i - 1].re + opt.max_chain_gap)
            continue;
        for (int64_t j = (int64_t)i - 1;
             j >= 0 && p.rid == regs[j].rid
             && p.rb < regs[j].re + opt.max_chain_gap; --j) {
            Reg& q = regs[j];
            if (q.qe == q.qb) continue;
            int64_t or_ = q.re - p.rb;
            int64_t oq = (q.qb < p.qb) ? (int64_t)(q.qe - p.qb)
                                       : (int64_t)(p.qe - q.qb);
            int64_t mr = std::min(q.re - q.rb, p.re - p.rb);
            int32_t mq = std::min(q.qe - q.qb, p.qe - p.qb);
            if (or_ > opt.mask_level_redun * mr
                && oq > opt.mask_level_redun * mq) {
                if (p.score < q.score) { p.qe = p.qb; break; }
                q.qe = q.qb;
            } else if (q.rb < p.rb) {
                // patching disabled without reference/query (the
                // rescue-dedup call, mem_patch_reg src/bwamem.cpp:206)
                PatchRes pr = ref_string == nullptr
                    ? PatchRes{0, 0}
                    : patch_reg(opt, bns, ref_string, query, q, p,
                                qtmp, ttmp, zbuf, Hbuf, Ebuf);
                if (pr.score > 0) {
                    p.n_comp += q.n_comp + 1;
                    p.seedcov = std::max(p.seedcov, q.seedcov);
                    p.sub = std::max(p.sub, q.sub);
                    p.csub = std::max(p.csub, q.csub);
                    p.qb = q.qb;
                    p.rb = q.rb;
                    p.truesc = p.score = pr.score;
                    p.w = pr.w;
                    q.qb = q.qe;  // kill q (qe == qb)
                }
            }
        }
    }
    regs.erase(std::remove_if(regs.begin(), regs.end(),
                              [](const Reg& r) { return r.qe <= r.qb; }),
               regs.end());
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg& x, const Reg& y) {
                         if (x.score != y.score) return x.score > y.score;
                         if (x.rb != y.rb) return x.rb < y.rb;
                         return x.qb < y.qb;
                     });
    for (size_t i = 1; i < regs.size(); ++i)
        if (regs[i].score == regs[i - 1].score
            && regs[i].rb == regs[i - 1].rb
            && regs[i].qb == regs[i - 1].qb)
            regs[i].qe = regs[i].qb;
    regs.erase(std::remove_if(regs.begin(), regs.end(),
                              [](const Reg& r) { return r.qe <= r.qb; }),
               regs.end());
}

// NOTE the Python oracle kills q by `q.qe = q.qb` in the redundancy
// branch and by `q.qb = q.qe` in the patch branch — both leave
// qe == qb, filtered identically above.

// ---- mark_primary (ref/finalize.py:126-194, mem_mark_primary_se) ----
void mark_primary_core(const Opt& opt, std::vector<Reg*>& a) {
    const int32_t tmp = std::max(opt.a + opt.b,
                                 std::max(opt.o_del + opt.e_del,
                                          opt.o_ins + opt.e_ins));
    std::vector<int> z = {0};
    for (int i = 1; i < (int)a.size(); ++i) {
        int found = -1;
        for (int k : z) {
            int32_t b_max = std::max(a[k]->qb, a[i]->qb);
            int32_t e_min = std::min(a[k]->qe, a[i]->qe);
            if (e_min > b_max) {
                int32_t min_l = std::min(a[i]->qe - a[i]->qb,
                                         a[k]->qe - a[k]->qb);
                if (e_min - b_max >= min_l * opt.mask_level) {
                    if (a[k]->sub == 0) a[k]->sub = a[i]->score;
                    if (a[k]->score - a[i]->score <= tmp
                        && (a[k]->is_alt || !a[i]->is_alt))
                        ++a[k]->sub_n;
                    found = k;
                    break;
                }
            }
        }
        if (found < 0) z.push_back(i);
        else a[i]->secondary = found;
    }
}

int mark_primary(const Opt& opt, std::vector<Reg>& regs, int64_t read_id) {
    const int n = (int)regs.size();
    if (n == 0) return 0;
    int n_pri = 0;
    for (int i = 0; i < n; ++i) {
        Reg& r = regs[i];
        r.sub = r.alt_sc = 0;
        r.secondary = r.secondary_all = -1;
        r.hash = hash_64((uint64_t)(read_id + i));
        if (!r.is_alt) ++n_pri;
    }
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg& x, const Reg& y) {
                         if (x.score != y.score) return x.score > y.score;
                         if (x.is_alt != y.is_alt) return !x.is_alt;
                         return x.hash < y.hash;
                     });
    {
        std::vector<Reg*> view(n);
        for (int i = 0; i < n; ++i) view[i] = &regs[i];
        mark_primary_core(opt, view);
    }
    for (int i = 0; i < n; ++i) {
        Reg& p = regs[i];
        p.secondary_all = i;
        if (!p.is_alt && p.secondary >= 0 && regs[p.secondary].is_alt)
            p.alt_sc = regs[p.secondary].score;
    }
    if (n_pri < n) {
        if (n_pri > 0)
            std::stable_sort(regs.begin(), regs.end(),
                             [](const Reg& x, const Reg& y) {
                                 if (x.is_alt != y.is_alt) return !x.is_alt;
                                 if (x.score != y.score)
                                     return x.score > y.score;
                                 return x.hash < y.hash;
                             });
        std::vector<int> z(n);
        for (int i = 0; i < n; ++i) z[regs[i].secondary_all] = i;
        for (int i = 0; i < n; ++i) {
            Reg& r = regs[i];
            if (r.secondary >= 0) {
                r.secondary_all = z[r.secondary];
                if (r.is_alt) r.secondary = SEC_ALT;
            } else {
                r.secondary_all = -1;
            }
        }
        if (n_pri > 0) {
            for (int i = 0; i < n_pri; ++i) {
                regs[i].sub = 0;
                regs[i].secondary = -1;
            }
            std::vector<Reg*> view(n_pri);
            for (int i = 0; i < n_pri; ++i) view[i] = &regs[i];
            mark_primary_core(opt, view);
        }
    } else {
        for (auto& r : regs) r.secondary_all = r.secondary;
    }
    return n_pri;
}

// ---- reorder_primary5 (ref/finalize.py:196-221) ----
void reorder_primary5(int32_t T, std::vector<Reg>& regs) {
    int n_pri = 0;
    for (auto& r : regs)
        if (r.secondary < 0 && !r.is_alt && r.score >= T) ++n_pri;
    if (n_pri <= 1) return;
    int32_t left_st = 1 << 30;
    int left_k = -1;
    for (int k = 0; k < (int)regs.size(); ++k) {
        const Reg& r = regs[k];
        if (r.secondary >= 0 || r.is_alt || r.score < T) continue;
        if (r.qb < left_st) { left_st = r.qb; left_k = k; }
    }
    if (left_k <= 0) return;
    std::swap(regs[0], regs[left_k]);
    for (int k = 1; k < (int)regs.size(); ++k) {
        Reg& r = regs[k];
        if (r.secondary == 0) r.secondary = left_k;
        else if (r.secondary == left_k) r.secondary = 0;
        if (r.secondary_all == 0) r.secondary_all = left_k;
        else if (r.secondary_all == left_k) r.secondary_all = 0;
    }
}

// ---- approx_mapq (ref/finalize.py:224-246, mem_approx_mapq_se) ----
int approx_mapq(const Opt& opt, const Reg& a) {
    int32_t sub = a.sub ? a.sub : opt.min_seed_len * opt.a;
    sub = std::max(a.csub, sub);
    if (sub >= a.score) return 0;
    int64_t l = std::max((int64_t)(a.qe - a.qb), a.re - a.rb);
    double identity = 1.0 - (double)(l * opt.a - a.score)
                            / (opt.a + opt.b) / (double)l;
    int mapq;
    if (a.score == 0) {
        mapq = 0;
    } else if (opt.mapQ_coef_len > 0) {
        double tmp = (l < opt.mapQ_coef_len)
                         ? 1.0
                         : opt.mapQ_coef_fac / std::log((double)l);
        tmp *= identity * identity;
        mapq = (int)(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499);
    } else {
        mapq = (int)(MEM_MAPQ_COEF * (1.0 - (double)sub / a.score)
                     * std::log((double)a.seedcov) + 0.499);
        if (identity < 0.95)
            mapq = (int)(mapq * identity * identity + 0.499);
    }
    if (a.sub_n > 0)
        mapq -= (int)(4.343 * std::log((double)a.sub_n + 1) + 0.499);
    mapq = std::min(mapq, 60);
    mapq = std::max(mapq, 0);
    return (int)(mapq * (1.0 - a.frac_rep) + 0.499);
}

int32_t infer_bw(int32_t l1, int32_t l2, int32_t score, int32_t a,
                 int32_t q, int32_t r) {
    if (l1 == l2 && l1 * a - score < ((q + r - a) << 1)) return 0;
    int32_t w = (int32_t)((double)(std::min(l1, l2) * a - score - q)
                          / r + 2.0);
    return std::max(w, std::abs(l1 - l2));
}

int64_t pos2rid(const Bns& bns, int64_t pos_f) {
    int64_t lo = 0, hi = bns.n_seqs - 1;
    while (lo < hi) {  // last offset <= pos_f
        int64_t mid = (lo + hi + 1) >> 1;
        if (bns.ann_off[mid] <= pos_f) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// ---- per-job cigar state ----
struct Job {
    const Reg* reg;
    std::vector<uint8_t> q, t;   // oriented slices
    int64_t rb, re;
    int32_t w2, truesc;
    bool is_fw;
    // results
    std::vector<uint32_t> cig;   // (len<<4 | op)
    int32_t score = 0, nm = -1;
    std::string md;
};

bool make_job(const Opt& opt, const Bns& bns, const uint8_t* ref_string,
              const uint8_t* query, int l_query, const Reg& ar, Job* out) {
    int32_t qb = ar.qb, qe = ar.qe;
    int64_t rb = ar.rb, re = ar.re;
    if (qe - qb <= 0 || rb >= re || (rb < bns.l_pac && re > bns.l_pac))
        return false;
    int32_t w2 = std::max(
        infer_bw(qe - qb, (int32_t)(re - rb), ar.truesc, opt.a, opt.o_del,
                 opt.e_del),
        infer_bw(qe - qb, (int32_t)(re - rb), ar.truesc, opt.a, opt.o_ins,
                 opt.e_ins));
    if (w2 > opt.w) w2 = std::min(w2, ar.w);
    out->reg = &ar;
    out->q.assign(query + qb, query + qe);
    out->t.assign(ref_string + rb, ref_string + re);
    if (rb >= bns.l_pac) {
        std::reverse(out->q.begin(), out->q.end());
        std::reverse(out->t.begin(), out->t.end());
    }
    out->rb = rb;
    out->re = re;
    out->w2 = w2;
    out->truesc = ar.truesc;
    out->is_fw = rb < bns.l_pac;
    return true;
}

void resolve_job(const Opt& opt, Job& j, std::vector<uint8_t>& zbuf,
                 std::vector<int32_t>& Hbuf, std::vector<int32_t>& Ebuf) {
    // bwa_gen_cigar2 band selection under mem_reg2aln's w2 retry loop
    const int lq = (int)j.q.size(), lt = (int)j.t.size();
    const int maxw = opt.w << 2;
    int w2 = std::min(j.w2, maxw);
    int32_t last_sc = -(1 << 30);
    int rounds = 0;
    while (true) {
        if (lq == lt && w2 == 0) {
            j.cig.clear();
            j.cig.push_back(((uint32_t)lq << 4) | 0);
            j.score = 0;
            for (int i = 0; i < lq; ++i)
                j.score += opt.mat[j.t[i] * 5 + j.q[i]];
        } else {
            const int m00 = opt.mat[0];
            const int max_ins = (int)((((lq + 1) >> 1) * (double)m00
                                       - opt.o_ins) / opt.e_ins + 1.0);
            const int max_del = (int)((((lq + 1) >> 1) * (double)m00
                                       - opt.o_del) / opt.e_del + 1.0);
            const int max_gap = std::max(std::max(max_ins, max_del), 1);
            int w = (max_gap + std::abs(lt - lq) + 1) >> 1;
            w = std::min(w, w2);
            w = std::max(w, std::abs(lt - lq) + 3);
            j.score = ksw_global(lq, j.q.data(), lt, j.t.data(), opt.mat,
                                 opt.o_del, opt.e_del, opt.o_ins,
                                 opt.e_ins, w, &j.cig, zbuf, Hbuf, Ebuf);
        }
        if (j.score == last_sc || w2 == maxw) break;
        last_sc = j.score;
        w2 <<= 1;
        ++rounds;
        if (!(rounds < 4 && j.score < j.truesc - opt.a)) break;
        w2 = std::min(w2, maxw);
    }
    char mdbuf[4096];
    int32_t mdlen = 0;
    nm_md(j.cig.data(), (int)j.cig.size(), j.q.data(), j.t.data(),
          j.is_fw ? 1 : 0, &j.nm, mdbuf, sizeof mdbuf, &mdlen);
    j.md.assign(mdbuf, mdlen);
}

// job_to_aln (pipeline/finalize.py:198-238)
struct AlnOut {
    int64_t pos = -1;
    int32_t rid = -1, flag = 0, mapq = 0, score = -1, sub = -1;
    int32_t nm = -1, alt_sc = 0;
    bool is_rev = false, is_alt = false;
    std::vector<uint32_t> cig;   // final (incl. soft clips, op 3)
    std::string md;
};

bool job_to_aln(const Opt& opt, const Bns& bns, const Job& j, int l_query,
                AlnOut* a) {
    const Reg& ar = *j.reg;
    a->mapq = (ar.secondary < 0) ? approx_mapq(opt, ar) : 0;
    a->flag = (ar.secondary >= 0) ? 0x100 : 0;
    a->nm = j.nm;
    a->md = j.md;
    int64_t p0 = j.is_fw ? j.rb : j.re - 1;
    a->is_rev = p0 >= bns.l_pac;
    int64_t pos = a->is_rev ? (bns.l_pac << 1) - 1 - p0 : p0;
    const uint32_t* cig = j.cig.data();
    int ncig = (int)j.cig.size();
    if (ncig) {
        if ((cig[0] & 0xf) == 2) {       // leading deletion
            pos += cig[0] >> 4;
            ++cig;
            --ncig;
        } else if ((cig[ncig - 1] & 0xf) == 2) {
            --ncig;
        }
    }
    a->cig.clear();
    const int32_t qb = ar.qb, qe = ar.qe;
    if (qb != 0 || qe != l_query) {
        int32_t clip5 = a->is_rev ? l_query - qe : qb;
        int32_t clip3 = a->is_rev ? qb : l_query - qe;
        if (clip5) a->cig.push_back(((uint32_t)clip5 << 4) | 3);
        a->cig.insert(a->cig.end(), cig, cig + ncig);
        if (clip3) a->cig.push_back(((uint32_t)clip3 << 4) | 3);
    } else {
        a->cig.assign(cig, cig + ncig);
    }
    int64_t rid = pos2rid(bns, pos);
    if (rid != ar.rid) return false;     // oracle asserts; flag instead
    a->rid = (int32_t)rid;
    a->pos = pos - bns.ann_off[rid];
    a->score = ar.score;
    a->sub = std::max(ar.sub, ar.csub);
    a->is_alt = ar.is_alt;
    a->alt_sc = ar.alt_sc;
    return true;
}


// ---- reusable record emission (mem_gen_alt + mem_reg2sam) ----------
// gen_xa_strings: per-primary XA tag strings (mem_gen_alt semantics,
// ref/finalize.py:337-374). select_read_records: the mem_reg2sam
// selection loop producing AlnOut records (+ their XA strings).
// Shared by the SE batch entry and the PE no-pairing branch.

struct WorkBufs {
    std::vector<uint8_t> qtmp, ttmp, zbuf;
    std::vector<int32_t> Hbuf, Ebuf;
    std::vector<Job> jobs;
};

struct RecOut {
    AlnOut a;
    std::string xa;
};

// returns false on rid-consistency failure
bool gen_xa_strings(const Opt& opt, const Bns& bns,
                    const uint8_t* ref_string, const uint8_t* query,
                    int l_query, std::vector<Reg>& regs,
                    std::vector<std::string>& xa_strings,
                    WorkBufs& wb) {
    const int n = (int)regs.size();
    xa_strings.assign(n, std::string());
    if (opt.flag & MEM_F_ALL) return true;
    std::vector<int> cnt(n, 0);
    std::vector<uint8_t> has_alt(n, 0);
    std::vector<int> xa_k, xa_r;
    auto pri_idx = [&](int k) -> int {
        int r = regs[k].secondary_all;
        if (r >= 0 && regs[k].score >= regs[r].score * opt.XA_drop_ratio)
            return r;
        return -1;
    };
    for (int k = 0; k < n; ++k) {
        int r = pri_idx(k);
        if (r >= 0) {
            ++cnt[r];
            if (regs[k].is_alt) has_alt[r] = 1;
        }
    }
    for (int k = 0; k < n; ++k) {
        int r = pri_idx(k);
        if (r < 0) continue;
        if (cnt[r] > opt.max_XA_hits_alt
            || (!has_alt[r] && cnt[r] > opt.max_XA_hits))
            continue;
        xa_k.push_back(k);
        xa_r.push_back(r);
    }
    for (size_t t_ = 0; t_ < xa_k.size(); ++t_) {
        Job j;
        if (!make_job(opt, bns, ref_string, query, l_query,
                      regs[xa_k[t_]], &j))
            continue;
        resolve_job(opt, j, wb.zbuf, wb.Hbuf, wb.Ebuf);
        AlnOut t;
        if (!job_to_aln(opt, bns, j, l_query, &t)) return false;
        std::string& s = xa_strings[xa_r[t_]];
        s += bns.names + bns.name_off[t.rid];
        s += ',';
        s += t.is_rev ? '-' : '+';
        s += std::to_string(t.pos + 1);
        s += ',';
        for (uint32_t c : t.cig) {
            s += std::to_string(c >> 4);
            s += "MIDSHN"[c & 0xf];
        }
        s += ',';
        s += std::to_string(t.nm);
        s += ';';
    }
    return true;
}

// mem_reg2sam selection + record composition; regs must be
// dedup'd + mark_primary'd (+PRIMARY5). Returns false on rid
// failure. Appends nothing when no region passes (caller emits the
// unmapped record).
bool select_read_records(const Opt& opt, const Bns& bns,
                         const uint8_t* ref_string,
                         const uint8_t* query, int l_query,
                         std::vector<Reg>& regs, int32_t extra_flag,
                         const std::vector<std::string>& xa_strings,
                         std::vector<RecOut>& out, WorkBufs& wb) {
    const int n = (int)regs.size();
    std::vector<int> sel_k;
    for (int k = 0; k < n; ++k) {
        const Reg& p = regs[k];
        if (p.score < opt.T) continue;
        if (p.secondary >= 0 && (p.is_alt || !(opt.flag & MEM_F_ALL)))
            continue;
        if (p.secondary >= 0 && p.secondary < SEC_ALT
            && p.score < regs[p.secondary].score * opt.drop_ratio)
            continue;
        sel_k.push_back(k);
    }
    int32_t l = 0, rec0_mapq = 0;
    for (size_t t_ = 0; t_ < sel_k.size(); ++t_) {
        const Reg& p = regs[sel_k[t_]];
        Job j;
        if (!make_job(opt, bns, ref_string, query, l_query, p, &j))
            continue;
        resolve_job(opt, j, wb.zbuf, wb.Hbuf, wb.Ebuf);
        RecOut ro;
        if (!job_to_aln(opt, bns, j, l_query, &ro.a)) return false;
        AlnOut& q = ro.a;
        q.flag |= extra_flag;
        if (p.secondary >= 0) q.sub = -1;
        if (l && p.secondary < 0)
            q.flag |= (opt.flag & MEM_F_NO_MULTI) ? 0x10000 : 0x800;
        if (!(opt.flag & MEM_F_KEEP_SUPP_MAPQ) && l && !p.is_alt
            && q.mapq > rec0_mapq)
            q.mapq = rec0_mapq;
        if (l == 0) rec0_mapq = q.mapq;
        ro.xa = xa_strings.empty() ? std::string()
                                   : xa_strings[sel_k[t_]];
        out.push_back(std::move(ro));
        ++l;
    }
    return true;
}

}  // namespace

extern "C" {

// Finalize a batch of reads from flat device-region rows.
//
// Region rows (length n_rows, read-major order): rr_read, rr_rb,
// rr_re (int64), rr_qb/qe/rid/score/truesc/w/seedcov/seedlen0 (int32).
// Reads listed in `proc_reads` (length n_proc, ascending) are
// processed; rows of other reads are skipped (Python handles
// overflow retries and EMF hits itself).
//
// Outputs: per processed read rd_nrec; flat per-record arrays in read
// order. cig_out stride = cig_stride uint32 ops; md/xa go into shared
// char arenas with per-record (off, len). Returns the total record
// count, or -1 on capacity overflow (caller falls back to Python),
// -2 on a rid-consistency failure.
int64_t finalize_se_batch(
    // regions
    int64_t n_rows, const int32_t* rr_read, const int64_t* rr_rb,
    const int64_t* rr_re, const int32_t* rr_qb, const int32_t* rr_qe,
    const int32_t* rr_rid, const int32_t* rr_score,
    const int32_t* rr_truesc, const int32_t* rr_w,
    const int32_t* rr_seedcov, const int32_t* rr_seedlen0,
    // per-read
    int64_t n_proc, const int32_t* proc_reads, const float* frac_rep,
    const int64_t* read_ids,
    const int32_t* codes, int64_t codes_stride, const int32_t* lens,
    // reference + annotations
    const uint8_t* ref_string, int64_t l_pac, int64_t n_seqs,
    const int64_t* ann_off, const int64_t* ann_len,
    const uint8_t* ann_is_alt, const char* names,
    const int64_t* name_off,
    // options
    const int8_t* mat, int32_t a, int32_t b, int32_t o_del,
    int32_t e_del, int32_t o_ins, int32_t e_ins, int32_t w, int32_t T,
    int32_t min_seed_len, int32_t max_chain_gap, double mask_level,
    double drop_ratio, double XA_drop_ratio, double mask_level_redun,
    int32_t max_XA_hits, int32_t max_XA_hits_alt, int32_t mapQ_coef_len,
    double mapQ_coef_fac, int32_t flag, int32_t extra_flag,
    // outputs
    int32_t* rd_nrec, int64_t rec_cap, int32_t* rec_read,
    int32_t* rec_rid, int64_t* rec_pos, int32_t* rec_flag,
    int32_t* rec_mapq, int32_t* rec_score, int32_t* rec_sub,
    int32_t* rec_nm, int32_t* rec_alt_sc, uint8_t* rec_is_rev,
    uint8_t* rec_is_alt, int32_t* rec_ncig, uint32_t* cig_out,
    int32_t cig_stride, char* md_arena, int64_t md_cap,
    int64_t* rec_md_off, int32_t* rec_md_len, char* xa_arena,
    int64_t xa_cap, int64_t* rec_xa_off, int32_t* rec_xa_len) {
    Opt opt;
    opt.a = a; opt.b = b; opt.o_del = o_del; opt.e_del = e_del;
    opt.o_ins = o_ins; opt.e_ins = e_ins; opt.w = w; opt.T = T;
    opt.min_seed_len = min_seed_len; opt.max_chain_gap = max_chain_gap;
    opt.mask_level = mask_level; opt.drop_ratio = drop_ratio;
    opt.XA_drop_ratio = XA_drop_ratio;
    opt.mask_level_redun = mask_level_redun;
    opt.max_XA_hits = max_XA_hits; opt.max_XA_hits_alt = max_XA_hits_alt;
    opt.mapQ_coef_len = mapQ_coef_len; opt.mapQ_coef_fac = mapQ_coef_fac;
    opt.flag = flag;
    std::memcpy(opt.mat, mat, 25);
    Bns bns{ann_off, ann_len, ann_is_alt, names, name_off, n_seqs, l_pac};

    std::vector<uint8_t> qtmp, ttmp, zbuf, qread;
    std::vector<int32_t> Hbuf, Ebuf;
    std::vector<Reg> regs;
    std::vector<Job> jobs;
    int64_t n_rec = 0, md_used = 0, xa_used = 0;
    int64_t row = 0;

    for (int64_t pi = 0; pi < n_proc; ++pi) {
        const int32_t i = proc_reads[pi];
        // advance to this read's rows (rows are read-major)
        while (row < n_rows && rr_read[row] < i) ++row;
        regs.clear();
        while (row < n_rows && rr_read[row] == i) {
            Reg r;
            r.rb = rr_rb[row]; r.re = rr_re[row];
            r.qb = rr_qb[row]; r.qe = rr_qe[row];
            r.rid = rr_rid[row]; r.score = rr_score[row];
            r.truesc = rr_truesc[row]; r.w = rr_w[row];
            r.seedcov = rr_seedcov[row]; r.seedlen0 = rr_seedlen0[row];
            r.is_alt = ann_is_alt[r.rid] != 0;
            r.frac_rep = frac_rep[i];
            regs.push_back(r);
            ++row;
        }
        const int l_query = lens[i];
        const int32_t* crow = codes + (int64_t)i * codes_stride;
        qread.resize(l_query);
        for (int k = 0; k < l_query; ++k) qread[k] = (uint8_t)crow[k];
        const uint8_t* query = qread.data();

        sort_dedup_patch(opt, bns, ref_string, query, regs, qtmp, ttmp,
                         zbuf, Hbuf, Ebuf);
        mark_primary(opt, regs, read_ids[i]);
        if (opt.flag & MEM_F_PRIMARY5) reorder_primary5(opt.T, regs);

        std::vector<std::string> xa_strings;
        WorkBufs wb;
        wb.qtmp.swap(qtmp); wb.ttmp.swap(ttmp); wb.zbuf.swap(zbuf);
        wb.Hbuf.swap(Hbuf); wb.Ebuf.swap(Ebuf);
        if (!gen_xa_strings(opt, bns, ref_string, query, l_query,
                            regs, xa_strings, wb))
            return -2;
        std::vector<RecOut> recs;
        if (!select_read_records(opt, bns, ref_string, query, l_query,
                                 regs, extra_flag, xa_strings, recs,
                                 wb))
            return -2;
        wb.qtmp.swap(qtmp); wb.ttmp.swap(ttmp); wb.zbuf.swap(zbuf);
        wb.Hbuf.swap(Hbuf); wb.Ebuf.swap(Ebuf);
        int32_t nrec_i = 0;
        for (const RecOut& ro : recs) {
            const AlnOut& q = ro.a;
            const std::string& xs = ro.xa;
            if (n_rec >= rec_cap || (int32_t)q.cig.size() > cig_stride)
                return -1;
            if (md_used + (int64_t)q.md.size() > md_cap
                || xa_used + (int64_t)xs.size() > xa_cap)
                return -1;
            rec_read[n_rec] = i;
            rec_rid[n_rec] = q.rid;
            rec_pos[n_rec] = q.pos;
            rec_flag[n_rec] = q.flag;
            rec_mapq[n_rec] = q.mapq;
            rec_score[n_rec] = q.score;
            rec_sub[n_rec] = q.sub;
            rec_nm[n_rec] = q.nm;
            rec_alt_sc[n_rec] = q.alt_sc;
            rec_is_rev[n_rec] = q.is_rev;
            rec_is_alt[n_rec] = q.is_alt;
            rec_ncig[n_rec] = (int32_t)q.cig.size();
            std::memcpy(cig_out + n_rec * cig_stride, q.cig.data(),
                        q.cig.size() * sizeof(uint32_t));
            std::memcpy(md_arena + md_used, q.md.data(), q.md.size());
            rec_md_off[n_rec] = md_used;
            rec_md_len[n_rec] = (int32_t)q.md.size();
            md_used += (int64_t)q.md.size();
            std::memcpy(xa_arena + xa_used, xs.data(), xs.size());
            rec_xa_off[n_rec] = xa_used;
            rec_xa_len[n_rec] = (int32_t)xs.size();
            xa_used += (int64_t)xs.size();
            ++nrec_i;
            ++n_rec;
        }
        if (nrec_i == 0) {
            if (n_rec >= rec_cap) return -1;
            rec_read[n_rec] = i;
            rec_rid[n_rec] = -1;
            rec_pos[n_rec] = -1;
            rec_flag[n_rec] = 0x4 | extra_flag;
            rec_mapq[n_rec] = 0;
            rec_score[n_rec] = -1;
            rec_sub[n_rec] = -1;
            rec_nm[n_rec] = -1;
            rec_alt_sc[n_rec] = 0;
            rec_is_rev[n_rec] = 0;
            rec_is_alt[n_rec] = 0;
            rec_ncig[n_rec] = 0;
            rec_md_off[n_rec] = md_used;
            rec_md_len[n_rec] = 0;
            rec_xa_off[n_rec] = xa_used;
            rec_xa_len[n_rec] = 0;
            nrec_i = 1;
            ++n_rec;
        }
        rd_nrec[pi] = nrec_i;
    }
    return n_rec;
}

}  // extern "C"

// ---- SAM text composition (mem_aln2sam, io/sam.py:52-145) ----------
//
// Composes final SE SAM lines straight from the flat record arrays
// finalize_se_batch produced (plus EMF perfect-hit records appended
// by the caller as synthetic rows). Per processed read, all its
// records' lines are concatenated into the shared text arena with
// one (off, len) per read. Returns bytes used, or -1 on arena
// overflow (caller falls back to the Python writer).

namespace {

inline void put_u32(std::string& s, uint32_t v) { s += std::to_string(v); }
inline void put_i64(std::string& s, int64_t v) { s += std::to_string(v); }

const char NT_FWD[] = "ACGTN";
const char NT_REV[] = "TGCAN";
const char CIG_OP[] = "MIDSHN";

}  // namespace

extern "C" {

int64_t compose_sam_se(
    // records (read-major, grouped)
    int64_t n_rec, const int32_t* rec_read, const int32_t* rec_rid,
    const int64_t* rec_pos, const int32_t* rec_flag,
    const int32_t* rec_mapq, const int32_t* rec_score,
    const int32_t* rec_sub, const int32_t* rec_nm,
    const int32_t* rec_alt_sc, const uint8_t* rec_is_rev,
    const uint8_t* rec_is_alt, const int32_t* rec_ncig,
    const uint32_t* cig_out, int32_t cig_stride,
    const char* md_arena, const int64_t* rec_md_off,
    const int32_t* rec_md_len, const char* xa_arena,
    const int64_t* rec_xa_off, const int32_t* rec_xa_len,
    // per-read inputs
    const int32_t* codes, int64_t codes_stride, const int32_t* lens,
    const char* qname_blob, const int64_t* qname_off,   // [B+1]
    const char* qual_blob, const int64_t* qual_off,     // nullable
    // contig names
    const char* names, const int64_t* name_off,
    // options
    int32_t opt_flag, const char* rg_id,
    // paired-end mate fields per read (all null for SE)
    const int32_t* mate_rid_a, const int64_t* mate_pos_a,
    const uint8_t* mate_is_rev_a, const int32_t* mate_rlen_a,
    // output
    char* sam_arena, int64_t sam_cap,
    int64_t* read_off, int32_t* read_len) {
    constexpr int32_t F_SOFTCLIP = 0x200;
    constexpr int32_t F_NO_MULTI_MARK = 0x10000;
    std::string line;
    std::string seqbuf, qualbuf;
    int64_t used = 0;
    int64_t r0 = 0;
    while (r0 < n_rec) {
        const int32_t i = rec_read[r0];
        int64_t r1 = r0;
        while (r1 < n_rec && rec_read[r1] == i) ++r1;
        const int nrec = (int)(r1 - r0);
        const int l_seq = lens[i];
        const int32_t* crow = codes + (int64_t)i * codes_stride;
        const int64_t rd_start = used;
        const bool pe = mate_rid_a != nullptr;
        for (int which = 0; which < nrec; ++which) {
            const int64_t r = r0 + which;
            int32_t flag = rec_flag[r];
            bool mapped = rec_rid[r] >= 0;
            int32_t prid = rec_rid[r];
            int64_t ppos = rec_pos[r];
            bool prev_ = rec_is_rev[r] != 0;
            bool pcig = mapped && rec_ncig[r] > 0;
            int32_t mrid = 0;
            int64_t mpos = 0;
            bool mrev = false;
            int32_t mrlen = 0;
            bool mcig = false;
            if (pe) {
                // mem_aln2sam mate-field composition (io/sam.py:57-95)
                flag |= 0x1;
                mrid = mate_rid_a[i];
                mpos = mate_pos_a[i];
                mrev = mate_is_rev_a[i] != 0;
                mrlen = mate_rlen_a[i];
                mcig = mrid >= 0 && mrlen > 0;
                if (!mapped) flag |= 0x4;
                if (mrid < 0) flag |= 0x8;
                if (!mapped && mrid >= 0) {
                    prid = mrid; ppos = mpos; prev_ = mrev;
                    pcig = false;
                }
                if (mrid < 0 && mapped) {
                    mrid = prid; mpos = ppos; mrev = prev_;
                    mcig = false;
                }
                if (prev_) flag |= 0x10;
                if (mrev) flag |= 0x20;
            } else {
                if (!mapped) flag |= 0x4;
                if (prev_) flag |= 0x10;
            }
            const bool show_ref = prid >= 0;
            line.clear();
            // QNAME, FLAG
            line.append(qname_blob + qname_off[i],
                        qname_off[i + 1] - qname_off[i]);
            line += '\t';
            put_u32(line, (uint32_t)((flag & 0xFFFF)
                                     | ((flag & F_NO_MULTI_MARK) ? 0x100
                                                                 : 0)));
            line += '\t';
            const int ncig = rec_ncig[r];
            const uint32_t* cig = cig_out + r * cig_stride;
            if (show_ref) {
                line += names + name_off[prid];
                line += '\t';
                put_i64(line, ppos + 1);
                line += '\t';
                put_u32(line, (uint32_t)rec_mapq[r]);
                line += '\t';
                if (!pcig || ncig == 0) {
                    line += '*';
                } else {
                    for (int c = 0; c < ncig; ++c) {
                        uint32_t op = cig[c] & 0xF;
                        if (!(opt_flag & F_SOFTCLIP) && !rec_is_alt[r]
                            && (op == 3 || op == 4))
                            op = which ? 4 : 3;
                        put_u32(line, cig[c] >> 4);
                        line += CIG_OP[op];
                    }
                }
            } else {
                line += "*\t0\t0\t*";
            }
            if (pe && mrid >= 0) {
                line += '\t';
                if (show_ref && prid == mrid) line += '=';
                else line += names + name_off[mrid];
                line += '\t';
                put_i64(line, mpos + 1);
                line += '\t';
                if (show_ref && prid == mrid && pcig && mcig) {
                    int64_t prlen = 0;
                    for (int c = 0; c < ncig; ++c) {
                        const uint32_t op = cig[c] & 0xF;
                        if (op == 0 || op == 2)
                            prlen += (int64_t)(cig[c] >> 4);
                    }
                    const int64_t p0 = ppos + (prev_ ? prlen - 1 : 0);
                    const int64_t p1 = mpos + (mrev ? mrlen - 1 : 0);
                    const int64_t sgn = p0 > p1 ? 1
                                        : (p0 < p1 ? -1 : 0);
                    put_i64(line, -(p0 - p1 + sgn));
                } else {
                    line += '0';
                }
                line += '\t';
            } else {
                line += "\t*\t0\t0\t";
            }
            // SEQ/QUAL
            if (flag & 0x100) {
                line += "*\t*";
            } else {
                int qb = 0, qe = l_seq;
                if (pcig && ncig && which && !(opt_flag & F_SOFTCLIP)
                    && !rec_is_alt[r]) {
                    const uint32_t f_op = cig[0] & 0xF,
                                   l_op = cig[ncig - 1] & 0xF;
                    const int32_t f_ln = cig[0] >> 4,
                                  l_ln = cig[ncig - 1] >> 4;
                    if (!prev_) {
                        if (f_op == 3 || f_op == 4) qb += f_ln;
                        if (l_op == 3 || l_op == 4) qe -= l_ln;
                    } else {
                        if (f_op == 3 || f_op == 4) qe -= f_ln;
                        if (l_op == 3 || l_op == 4) qb += l_ln;
                    }
                }
                seqbuf.clear();
                if (!prev_) {
                    for (int k = qb; k < qe; ++k) {
                        int32_t c = crow[k];
                        seqbuf += NT_FWD[c > 4 ? 4 : c];
                    }
                } else {
                    for (int k = qe - 1; k >= qb; --k) {
                        int32_t c = crow[k];
                        seqbuf += NT_REV[c > 4 ? 4 : c];
                    }
                }
                line += seqbuf;
                line += '\t';
                if (qual_blob) {
                    const char* qs = qual_blob + qual_off[i];
                    const int64_t ql = qual_off[i + 1] - qual_off[i];
                    if (ql == 0) {
                        line += '*';
                    } else if (!prev_) {
                        line.append(qs + qb, qe - qb);
                    } else {
                        for (int k = qe - 1; k >= qb; --k) line += qs[k];
                    }
                } else {
                    line += '*';
                }
            }
            // tags
            if (pcig && ncig) {
                line += "\tNM:i:";
                put_u32(line, (uint32_t)rec_nm[r]);
                line += "\tMD:Z:";
                line.append(md_arena + rec_md_off[r], rec_md_len[r]);
            }
            if (rec_score[r] >= 0) {
                line += "\tAS:i:";
                put_u32(line, (uint32_t)rec_score[r]);
            }
            if (rec_sub[r] >= 0) {
                line += "\tXS:i:";
                put_u32(line, (uint32_t)rec_sub[r]);
            }
            if (rg_id && *rg_id) {
                line += "\tRG:Z:";
                line += rg_id;
            }
            if (!(flag & 0x100)) {
                bool any_other = false;
                for (int o = 0; o < nrec; ++o)
                    if (o != which && !(rec_flag[r0 + o] & 0x100))
                        any_other = true;
                if (any_other) {
                    line += "\tSA:Z:";
                    for (int o = 0; o < nrec; ++o) {
                        const int64_t rr = r0 + o;
                        if (o == which || (rec_flag[rr] & 0x100))
                            continue;
                        line += names + name_off[rec_rid[rr]];
                        line += ',';
                        put_i64(line, rec_pos[rr] + 1);
                        line += ',';
                        line += rec_is_rev[rr] ? '-' : '+';
                        line += ',';
                        const uint32_t* oc = cig_out + rr * cig_stride;
                        for (int c = 0; c < rec_ncig[rr]; ++c) {
                            put_u32(line, oc[c] >> 4);
                            line += CIG_OP[oc[c] & 0xF];
                        }
                        line += ',';
                        put_u32(line, (uint32_t)rec_mapq[rr]);
                        line += ',';
                        put_u32(line, (uint32_t)rec_nm[rr]);
                        line += ';';
                    }
                }
                if (rec_alt_sc[r] > 0) {
                    char buf[40];
                    snprintf(buf, sizeof buf, "\tpa:f:%.3f",
                             (double)rec_score[r] / rec_alt_sc[r]);
                    line += buf;
                }
            }
            if (rec_xa_len[r]) {
                line += "\tXA:Z:";
                line.append(xa_arena + rec_xa_off[r], rec_xa_len[r]);
            }
            line += '\n';
            if (used + (int64_t)line.size() > sam_cap) return -1;
            std::memcpy(sam_arena + used, line.data(), line.size());
            used += (int64_t)line.size();
        }
        read_off[i] = rd_start;
        read_len[i] = (int32_t)(used - rd_start);
        r0 = r1;
    }
    return used;
}

}  // extern "C"

// ==================== Paired-end host pipeline =====================
//
// Native port of pipeline/pe.py (behavior contracts from the
// reference: mem_pestat src/bwamem_pair.cpp:89-156, mem_matesw_orig
// :276-364, mem_pair :366-427, mem_sam_pe :625-818) — dedup, insert
// -size stats, batched mate rescue (kswa_core), pairing, and record
// composition for a whole batch of pairs in one call. The Python
// path (pipeline/pe.py) stays as the oracle and fallback;
// tests/test_native_pe.py asserts record equality.

#include "kswa_core.h"

namespace {

constexpr double PE_OUTLIER = 2.0;
constexpr double PE_MAPPING = 3.0;
constexpr double PE_MAX_STD = 4.0;
constexpr double PE_MIN_RATIO = 0.8;
constexpr int PE_MIN_DIR_CNT = 10;
constexpr double PE_MIN_DIR_RATIO = 0.05;
constexpr int32_t MEM_F_NOPAIRING = 0x4;   // config.py MEM_F_NOPAIRING
constexpr int32_t MEM_F_NO_RESCUE = 0x40;  // config.py MEM_F_NO_RESCUE

struct PeOpt {
    int32_t max_ins = 10000, pen_unpaired = 17, max_matesw = 50;
};

struct PeStatC {
    int64_t low = 0, high = 0;
    double avg = 0.0, stdv = 0.0;
    bool failed = true;
};

inline void infer_dir(int64_t l_pac, int64_t b1, int64_t b2, int* d,
                      int64_t* dist) {
    const bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
    const int64_t p2 = (r1 == r2) ? b2 : (l_pac << 1) - 1 - b2;
    *dist = p2 > b1 ? p2 - b1 : b1 - p2;
    *d = ((r1 == r2) ? 0 : 1) ^ ((p2 > b1) ? 0 : 3);
}

int32_t cal_sub(const Opt& opt, const std::vector<Reg>& regs) {
    for (size_t j = 1; j < regs.size(); ++j) {
        int32_t b_max = std::max(regs[j].qb, regs[0].qb);
        int32_t e_min = std::min(regs[j].qe, regs[0].qe);
        if (e_min > b_max) {
            int32_t min_l = std::min(regs[j].qe - regs[j].qb,
                                     regs[0].qe - regs[0].qb);
            if (e_min - b_max >= min_l * opt.mask_level)
                return regs[j].score;
        }
    }
    return opt.min_seed_len * opt.a;
}

void pe_stat(const Opt& opt, const PeOpt& pe, int64_t l_pac,
             const std::vector<std::vector<Reg>>& regs_by_read,
             int64_t n_pairs, PeStatC pes[4]) {
    std::vector<int64_t> isize[4];
    for (int64_t p = 0; p < n_pairs; ++p) {
        const auto& r0 = regs_by_read[2 * p];
        const auto& r1 = regs_by_read[2 * p + 1];
        if (r0.empty() || r1.empty()) continue;
        if (cal_sub(opt, r0) > PE_MIN_RATIO * r0[0].score) continue;
        if (cal_sub(opt, r1) > PE_MIN_RATIO * r1[0].score) continue;
        if (r0[0].rid != r1[0].rid) continue;
        int d;
        int64_t dist;
        infer_dir(l_pac, r0[0].rb, r1[0].rb, &d, &dist);
        if (dist && dist <= pe.max_ins) isize[d].push_back(dist);
    }
    size_t mx = 0;
    for (int d = 0; d < 4; ++d) mx = std::max(mx, isize[d].size());
    for (int d = 0; d < 4; ++d) {
        auto& q = isize[d];
        PeStatC& r = pes[d];
        r = PeStatC();
        if ((int)q.size() < PE_MIN_DIR_CNT) continue;
        std::sort(q.begin(), q.end());
        const int64_t p25 = q[(size_t)(0.25 * q.size() + 0.499)];
        const int64_t p75 = q[(size_t)(0.75 * q.size() + 0.499)];
        r.low = std::max((int64_t)(p25 - PE_OUTLIER * (p75 - p25)
                                   + 0.499), (int64_t)1);
        r.high = (int64_t)(p75 + PE_OUTLIER * (p75 - p25) + 0.499);
        double sum = 0;
        int64_t cnt = 0;
        for (int64_t x : q)
            if (r.low <= x && x <= r.high) { sum += x; ++cnt; }
        r.avg = sum / cnt;
        double ss = 0;
        for (int64_t x : q)
            if (r.low <= x && x <= r.high)
                ss += (x - r.avg) * (x - r.avg);
        r.stdv = std::sqrt(ss / cnt);
        r.low = (int64_t)(p25 - PE_MAPPING * (p75 - p25) + 0.499);
        r.high = (int64_t)(p75 + PE_MAPPING * (p75 - p25) + 0.499);
        r.low = std::min(r.low,
                         (int64_t)(r.avg - PE_MAX_STD * r.stdv + 0.499));
        r.high = std::max(r.high,
                          (int64_t)(r.avg + PE_MAX_STD * r.stdv
                                    + 0.499));
        r.low = std::max(r.low, (int64_t)1);
        r.failed = false;
    }
    for (int d = 0; d < 4; ++d)
        if (!pes[d].failed
            && (double)isize[d].size() < mx * PE_MIN_DIR_RATIO)
            pes[d].failed = true;
}

struct RescueJob {
    int64_t pair;
    int end;
    std::vector<uint8_t> seq, target;
    bool is_rev;
    int64_t rb;
    int l_ms, rid;
    bool is_alt;
};

// bns_fetch_seq clamp (pipeline/pe.py:_fetch_seq)
void fetch_seq_clamp(const Bns& bns, int64_t* rb, int64_t mid,
                     int64_t* re, int64_t* rid_out) {
    const int64_t l_pac = bns.l_pac;
    const bool is_rev = mid >= l_pac;
    const int64_t pos_f = is_rev ? 2 * l_pac - 1 - mid : mid;
    const int64_t rid = pos2rid(bns, pos_f);
    const int64_t off = bns.ann_off[rid];
    const int64_t end = off + bns.ann_len[rid];
    int64_t lo, hi;
    if (is_rev) { lo = 2 * l_pac - end; hi = 2 * l_pac - off; }
    else { lo = off; hi = end; }
    *rb = std::max(*rb, lo);
    *re = std::min(*re, hi);
    *rid_out = rid;
}

void build_rescue_jobs(const Opt& opt, const PeOpt& pe, const Bns& bns,
                       const uint8_t* ref_string,
                       const PeStatC pes[4],
                       std::vector<std::vector<Reg>>& regs_by_read,
                       const int32_t* codes, int64_t codes_stride,
                       const int32_t* lens, int64_t n_pairs,
                       std::vector<RescueJob>& jobs) {
    if (opt.flag & MEM_F_NO_RESCUE) return;
    const int64_t l_pac = bns.l_pac;
    for (int64_t p = 0; p < n_pairs; ++p) {
        for (int i = 0; i < 2; ++i) {
            auto& a_list = regs_by_read[2 * p + i];
            if (a_list.empty()) continue;
            auto& ma = regs_by_read[2 * p + (1 - i)];
            const int32_t* mrow = codes
                + (int64_t)(2 * p + (1 - i)) * codes_stride;
            const int l_ms = lens[2 * p + (1 - i)];
            int n_cand = 0;
            for (size_t ci = 0; ci < a_list.size()
                 && n_cand < pe.max_matesw; ++ci) {
                const Reg& a = a_list[ci];
                if (a.score < a_list[0].score - pe.pen_unpaired)
                    continue;
                ++n_cand;
                bool skip[4];
                for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed;
                for (const Reg& m : ma) {
                    int r;
                    int64_t dist;
                    infer_dir(l_pac, a.rb, m.rb, &r, &dist);
                    if (pes[r].low <= dist && dist <= pes[r].high)
                        skip[r] = true;
                }
                if (skip[0] && skip[1] && skip[2] && skip[3]) continue;
                for (int r = 0; r < 4; ++r) {
                    if (skip[r]) continue;
                    const bool is_rev = (r >> 1) != (r & 1);
                    const bool is_larger = !(r >> 1);
                    int64_t rb, re;
                    if (!is_rev) {
                        rb = is_larger ? a.rb + pes[r].low
                                       : a.rb - pes[r].high;
                        re = (is_larger ? a.rb + pes[r].high
                                        : a.rb - pes[r].low) + l_ms;
                    } else {
                        rb = (is_larger ? a.rb + pes[r].low
                                        : a.rb - pes[r].high) - l_ms;
                        re = is_larger ? a.rb + pes[r].high
                                       : a.rb - pes[r].low;
                    }
                    rb = std::max(rb, (int64_t)0);
                    re = std::min(re, l_pac << 1);
                    if (rb >= re) continue;
                    int64_t rid;
                    fetch_seq_clamp(bns, &rb, (rb + re) >> 1, &re,
                                    &rid);
                    if (rid != a.rid || re - rb < opt.min_seed_len)
                        continue;
                    RescueJob j;
                    j.pair = p;
                    j.end = 1 - i;
                    j.seq.resize(l_ms);
                    if (is_rev) {
                        for (int k = 0; k < l_ms; ++k) {
                            int32_t c = mrow[l_ms - 1 - k];
                            j.seq[k] = c < 4 ? (uint8_t)(3 - c)
                                             : (uint8_t)4;
                        }
                    } else {
                        for (int k = 0; k < l_ms; ++k)
                            j.seq[k] = (uint8_t)mrow[k];
                    }
                    j.target.assign(ref_string + rb, ref_string + re);
                    j.is_rev = is_rev;
                    j.rb = rb;
                    j.l_ms = l_ms;
                    j.rid = (int)rid;
                    j.is_alt = a.is_alt;
                    jobs.push_back(std::move(j));
                }
            }
        }
    }
}

void run_apply_rescues(const Opt& opt, const Bns& bns,
                       std::vector<RescueJob>& jobs,
                       std::vector<std::vector<Reg>>& regs_by_read,
                       std::vector<uint8_t>& qtmp,
                       std::vector<uint8_t>& ttmp,
                       std::vector<uint8_t>& zbuf,
                       std::vector<int32_t>& Hbuf,
                       std::vector<int32_t>& Ebuf) {
    const int64_t l_pac = bns.l_pac;
    const int32_t minsc = opt.min_seed_len * opt.a;
    std::vector<int64_t> H_best, colmax, Hrow, Erow;
    std::vector<uint8_t> rq, rt;
    std::vector<std::pair<int64_t, int>> touched;
    for (RescueJob& j : jobs) {
        int32_t o[6];
        kswa_core::ksw_align_one(
            j.seq.data(), (int)j.seq.size(), j.target.data(),
            (int)j.target.size(), opt.mat, opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, minsc, o, H_best, colmax, Hrow,
            Erow, rq, rt);
        const int32_t score = o[0], te = o[1], qe = o[2],
                      score2 = o[3], tb = o[4], qb = o[5];
        if (score < opt.min_seed_len || qb < 0) continue;
        Reg b;
        b.rid = j.rid;
        b.is_alt = j.is_alt;
        if (j.is_rev) {
            b.qb = j.l_ms - (qe + 1);
            b.qe = j.l_ms - qb;
            b.rb = (l_pac << 1) - (j.rb + te + 1);
            b.re = (l_pac << 1) - (j.rb + tb);
        } else {
            b.qb = qb;
            b.qe = qe + 1;
            b.rb = j.rb + tb;
            b.re = j.rb + te + 1;
        }
        b.score = b.truesc = score;
        b.csub = score2;
        b.secondary = -1;
        b.seedcov = (int32_t)(std::min(b.re - b.rb,
                                       (int64_t)(b.qe - b.qb)) >> 1);
        b.w = 0;
        b.seedlen0 = 0;
        b.frac_rep = 0.0;
        regs_by_read[2 * j.pair + j.end].push_back(b);
        touched.push_back({j.pair, j.end});
    }
    std::sort(touched.begin(), touched.end());
    touched.erase(std::unique(touched.begin(), touched.end()),
                  touched.end());
    for (auto& t : touched)
        sort_dedup_patch(opt, bns, nullptr, nullptr,
                         regs_by_read[2 * t.first + t.second], qtmp,
                         ttmp, zbuf, Hbuf, Ebuf);
}

inline int raw_mapq_pe(int32_t diff, int32_t a) {
    return (int)(6.02 * diff / a + 0.499);
}

// mem_pair (pipeline/pe.py:298-360). Returns score o (0 = no pair).
void mem_pair_c(const Opt& opt, const Bns& bns, const PeStatC pes[4],
                std::vector<Reg>* regs2[2], int64_t pair_id,
                const int n_pri[2], int32_t* o_out, int32_t* sub_out,
                int32_t* nsub_out, int z[2]) {
    const int64_t l_pac = bns.l_pac;
    std::vector<std::pair<int64_t, int64_t>> v;
    for (int r = 0; r < 2; ++r) {
        for (int i = 0; i < n_pri[r]; ++i) {
            const Reg& e = (*regs2[r])[i];
            const int64_t pos_f = e.rb < l_pac
                ? e.rb : (l_pac << 1) - 1 - e.rb;
            const int64_t x = ((int64_t)e.rid << 32)
                | (pos_f - bns.ann_off[e.rid]);
            const int64_t y = ((int64_t)e.score << 32)
                | ((int64_t)i << 2)
                | ((e.rb >= l_pac) ? 2 : 0) | r;
            v.push_back({x, y});
        }
    }
    std::sort(v.begin(), v.end());
    int64_t y4[4] = {-1, -1, -1, -1};
    std::vector<std::pair<uint64_t, uint64_t>> u;
    for (size_t i = 0; i < v.size(); ++i) {
        for (int r = 0; r < 2; ++r) {
            const int d = (r << 1) | ((v[i].second >> 1) & 1);
            if (pes[d].failed) continue;
            const int which = (r << 1) | (((int)v[i].second & 1) ^ 1);
            if (y4[which] < 0) continue;
            for (int64_t k = y4[which]; k >= 0; --k) {
                if (((int)v[k].second & 3) != which) continue;
                const int64_t dist = v[i].first - v[k].first;
                if (dist > pes[d].high) break;
                if (dist < pes[d].low) continue;
                const double ns = (dist - pes[d].avg) / pes[d].stdv;
                int64_t q = (int64_t)(
                    (double)((v[i].second >> 32)
                             + (v[k].second >> 32))
                    + 0.721 * std::log(2.0 * std::erfc(
                          std::fabs(ns) * M_SQRT1_2)) * opt.a
                    + 0.499);
                if (q < 0) q = 0;
                const uint64_t yk = ((uint64_t)k << 32) | (uint64_t)i;
                u.push_back({((uint64_t)q << 32)
                             | (hash_64((yk ^ ((uint64_t)pair_id
                                               << 8)))
                                & 0xFFFFFFFFULL),
                             yk});
            }
        }
        y4[(int)v[i].second & 3] = (int64_t)i;
    }
    z[0] = z[1] = -1;
    if (u.empty()) {
        *o_out = *sub_out = *nsub_out = 0;
        return;
    }
    const int32_t tmp = std::max(opt.a + opt.b,
                                 std::max(opt.o_del + opt.e_del,
                                          opt.o_ins + opt.e_ins));
    std::sort(u.begin(), u.end());
    const uint64_t yk = u.back().second;
    const size_t i = (size_t)(yk >> 32);
    const size_t k = (size_t)(yk & 0xFFFFFFFFULL);
    z[(int)v[i].second & 1] = (int)((v[i].second >> 2) & 0x3FFFFFFF);
    z[(int)v[k].second & 1] = (int)((v[k].second >> 2) & 0x3FFFFFFF);
    *o_out = (int32_t)(u.back().first >> 32);
    *sub_out = u.size() > 1
        ? (int32_t)(u[u.size() - 2].first >> 32) : 0;
    int nsub = 0;
    for (int64_t j = (int64_t)u.size() - 2; j >= 0; --j)
        if (*sub_out - (int32_t)(u[j].first >> 32) <= tmp) ++nsub;
    *nsub_out = nsub;
}

// reg2aln(None): the unmapped record
AlnOut unmapped_aln() {
    AlnOut a;
    a.rid = -1;
    a.pos = -1;
    a.flag = 0x4;
    a.mapq = 0;
    a.score = -1;
    a.sub = -1;
    a.nm = -1;
    return a;
}

// reg2aln for one region via the job machinery (equality with the
// SE path is asserted by tests/test_native_finalize.py)
bool reg_to_aln(const Opt& opt, const Bns& bns,
                const uint8_t* ref_string, const uint8_t* query,
                int l_query, const Reg& p, AlnOut* out, WorkBufs& wb) {
    Job j;
    if (!make_job(opt, bns, ref_string, query, l_query, p, &j)) {
        *out = unmapped_aln();
        return true;
    }
    resolve_job(opt, j, wb.zbuf, wb.Hbuf, wb.Ebuf);
    return job_to_aln(opt, bns, j, l_query, out);
}

}  // namespace

namespace {

struct PairOut {
    std::vector<RecOut> recs[2];
    AlnOut mate[2];
};

// mem_sam_pe after rescue (pipeline/pe.py:363-497, batcher=None)
bool sam_pe_one(const Opt& opt, const PeOpt& pe, const Bns& bns,
                const uint8_t* ref_string, const PeStatC pes[4],
                int64_t pair_id, const uint8_t* q[2], const int lq[2],
                std::vector<Reg>* regs2[2], PairOut* out,
                WorkBufs& wb) {
    int n_pri[2];
    for (int i = 0; i < 2; ++i) {
        n_pri[i] = mark_primary(opt, *regs2[i],
                                (pair_id << 1) | (int64_t)i);
        if (opt.flag & MEM_F_PRIMARY5)
            reorder_primary5(opt.T, *regs2[i]);
    }

    auto no_pairing = [&]() -> bool {
        int32_t extra = 1;
        AlnOut h[2];
        for (int i = 0; i < 2; ++i) {
            int which = -1;
            const auto& a = *regs2[i];
            if (!a.empty()) {
                if (a[0].score >= opt.T) which = 0;
                else if (n_pri[i] < (int)a.size()
                         && a[n_pri[i]].score >= opt.T)
                    which = n_pri[i];
            }
            if (which >= 0) {
                if (!reg_to_aln(opt, bns, ref_string, q[i], lq[i],
                                a[which], &h[i], wb))
                    return false;
            } else {
                h[i] = unmapped_aln();
            }
        }
        if (!(opt.flag & MEM_F_NOPAIRING) && h[0].rid == h[1].rid
            && h[0].rid >= 0 && !regs2[0]->empty()
            && !regs2[1]->empty()) {
            int d;
            int64_t dist;
            infer_dir(bns.l_pac, (*regs2[0])[0].rb,
                      (*regs2[1])[0].rb, &d, &dist);
            if (!pes[d].failed && pes[d].low <= dist
                && dist <= pes[d].high)
                extra |= 2;
        }
        for (int i = 0; i < 2; ++i) {
            const int32_t ef = (i == 0 ? 0x41 : 0x81) | extra;
            std::vector<std::string> xa;
            if (!gen_xa_strings(opt, bns, ref_string, q[i], lq[i],
                                *regs2[i], xa, wb))
                return false;
            if (!select_read_records(opt, bns, ref_string, q[i],
                                     lq[i], *regs2[i], ef, xa,
                                     out->recs[i], wb))
                return false;
            if (out->recs[i].empty()) {
                RecOut ro;
                ro.a = unmapped_aln();
                ro.a.flag |= ef;
                out->recs[i].push_back(std::move(ro));
            }
        }
        out->mate[0] = h[1];
        out->mate[1] = h[0];
        return true;
    };

    if (opt.flag & MEM_F_NOPAIRING) return no_pairing();
    if (!(n_pri[0] && n_pri[1])) return no_pairing();
    int32_t o, subo, n_sub;
    int z[2];
    mem_pair_c(opt, bns, pes, regs2, pair_id, n_pri, &o, &subo,
               &n_sub, z);
    if (o <= 0) return no_pairing();
    for (int i = 0; i < 2; ++i)
        for (int j = 1; j < n_pri[i]; ++j)
            if ((*regs2[i])[j].secondary < 0
                && (*regs2[i])[j].score >= opt.T)
                return no_pairing();

    int32_t extra_flag = 1;
    const int32_t score_un = (*regs2[0])[0].score
        + (*regs2[1])[0].score - pe.pen_unpaired;
    subo = std::max(subo, score_un);
    int q_pe = raw_mapq_pe(o - subo, opt.a);
    if (n_sub > 0)
        q_pe -= (int)(4.343 * std::log((double)n_sub + 1) + 0.499);
    q_pe = std::min(std::max(q_pe, 0), 60);
    q_pe = (int)(q_pe * (1.0 - 0.5 * ((*regs2[0])[0].frac_rep
                                      + (*regs2[1])[0].frac_rep))
                 + 0.499);

    int q_se[2] = {0, 0};
    if (o > score_un) {
        Reg* c[2] = {&(*regs2[0])[z[0]], &(*regs2[1])[z[1]]};
        for (int i = 0; i < 2; ++i) {
            if (c[i]->secondary >= 0) {
                c[i]->sub = (*regs2[i])[c[i]->secondary].score;
                c[i]->secondary = -2;
            }
            q_se[i] = approx_mapq(opt, *c[i]);
        }
        for (int i = 0; i < 2; ++i) {
            q_se[i] = (q_se[i] > q_pe) ? q_se[i]
                                       : std::min(q_pe, q_se[i] + 40);
            q_se[i] = std::min(
                q_se[i], raw_mapq_pe(c[i]->score - c[i]->csub, opt.a));
        }
        extra_flag |= 2;
    } else {
        z[0] = z[1] = 0;
        q_se[0] = approx_mapq(opt, (*regs2[0])[0]);
        q_se[1] = approx_mapq(opt, (*regs2[1])[0]);
    }

    for (int i = 0; i < 2; ++i) {
        const int k = (*regs2[i])[z[i]].secondary_all;
        if (0 <= k && k < n_pri[i]) {
            for (int j = 0; j < (int)regs2[i]->size(); ++j)
                if ((*regs2[i])[j].secondary_all == k || j == k)
                    (*regs2[i])[j].secondary_all = z[i];
            (*regs2[i])[z[i]].secondary_all = -1;
        }
    }

    std::vector<std::string> XA[2];
    if (!(opt.flag & MEM_F_ALL)) {
        for (int i = 0; i < 2; ++i)
            if (!gen_xa_strings(opt, bns, ref_string, q[i], lq[i],
                                *regs2[i], XA[i], wb))
                return false;
    }

    AlnOut h[2];
    for (int i = 0; i < 2; ++i) {
        if (!reg_to_aln(opt, bns, ref_string, q[i], lq[i],
                        (*regs2[i])[z[i]], &h[i], wb))
            return false;
        h[i].mapq = q_se[i];
        h[i].flag |= (0x40 << i) | extra_flag;
        RecOut ro;
        ro.a = h[i];
        if (!XA[i].empty()) ro.xa = XA[i][z[i]];
        out->recs[i].push_back(std::move(ro));
        if (n_pri[i] < (int)regs2[i]->size()) {
            const Reg& p = (*regs2[i])[n_pri[i]];
            if (p.score >= opt.T && p.secondary < 0 && p.is_alt) {
                RecOut rg;
                if (!reg_to_aln(opt, bns, ref_string, q[i], lq[i], p,
                                &rg.a, wb))
                    return false;
                rg.a.flag |= 0x800 | (0x40 << i) | extra_flag;
                if (!XA[i].empty()) rg.xa = XA[i][n_pri[i]];
                out->recs[i].push_back(std::move(rg));
            }
        }
    }
    out->mate[0] = h[1];
    out->mate[1] = h[0];
    return true;
}

}  // namespace

extern "C" {

// Paired-end batch: raw (pre-dedup) region rows for 2*n_pairs reads
// -> finished records + per-read mate fields. Returns total record
// count, -1 on capacity overflow, -2 on rid failure.
int64_t finalize_pe_batch(
    int64_t n_rows, const int32_t* rr_read, const int64_t* rr_rb,
    const int64_t* rr_re, const int32_t* rr_qb, const int32_t* rr_qe,
    const int32_t* rr_rid, const int32_t* rr_score,
    const int32_t* rr_truesc, const int32_t* rr_w,
    const int32_t* rr_seedcov, const int32_t* rr_seedlen0,
    int64_t n_pairs, const float* frac_rep, const int64_t* read_ids,
    const uint8_t* skip_dedup,
    const int32_t* codes, int64_t codes_stride, const int32_t* lens,
    const uint8_t* ref_string, int64_t l_pac, int64_t n_seqs,
    const int64_t* ann_off, const int64_t* ann_len,
    const uint8_t* ann_is_alt, const char* names,
    const int64_t* name_off,
    const int8_t* mat, int32_t a, int32_t b, int32_t o_del,
    int32_t e_del, int32_t o_ins, int32_t e_ins, int32_t w, int32_t T,
    int32_t min_seed_len, int32_t max_chain_gap, double mask_level,
    double drop_ratio, double XA_drop_ratio, double mask_level_redun,
    int32_t max_XA_hits, int32_t max_XA_hits_alt, int32_t mapQ_coef_len,
    double mapQ_coef_fac, int32_t flag,
    int32_t max_ins, int32_t pen_unpaired, int32_t max_matesw,
    // insert-size stats: pes_io[d*5..] = low, high, avg, std, failed;
    // use_pes_in != 0 -> consume, else computed and written back
    double* pes_io, int32_t use_pes_in,
    // outputs (as finalize_se_batch) + mate fields per read
    int32_t* rd_nrec, int64_t rec_cap, int32_t* rec_read,
    int32_t* rec_rid, int64_t* rec_pos, int32_t* rec_flag,
    int32_t* rec_mapq, int32_t* rec_score, int32_t* rec_sub,
    int32_t* rec_nm, int32_t* rec_alt_sc, uint8_t* rec_is_rev,
    uint8_t* rec_is_alt, int32_t* rec_ncig, uint32_t* cig_out,
    int32_t cig_stride, char* md_arena, int64_t md_cap,
    int64_t* rec_md_off, int32_t* rec_md_len, char* xa_arena,
    int64_t xa_cap, int64_t* rec_xa_off, int32_t* rec_xa_len,
    int32_t* mate_rid, int64_t* mate_pos, uint8_t* mate_is_rev,
    int32_t* mate_rlen) {
    Opt opt;
    opt.a = a; opt.b = b; opt.o_del = o_del; opt.e_del = e_del;
    opt.o_ins = o_ins; opt.e_ins = e_ins; opt.w = w; opt.T = T;
    opt.min_seed_len = min_seed_len; opt.max_chain_gap = max_chain_gap;
    opt.mask_level = mask_level; opt.drop_ratio = drop_ratio;
    opt.XA_drop_ratio = XA_drop_ratio;
    opt.mask_level_redun = mask_level_redun;
    opt.max_XA_hits = max_XA_hits; opt.max_XA_hits_alt = max_XA_hits_alt;
    opt.mapQ_coef_len = mapQ_coef_len; opt.mapQ_coef_fac = mapQ_coef_fac;
    opt.flag = flag;
    std::memcpy(opt.mat, mat, 25);
    PeOpt pe;
    pe.max_ins = max_ins;
    pe.pen_unpaired = pen_unpaired;
    pe.max_matesw = max_matesw;
    Bns bns{ann_off, ann_len, ann_is_alt, names, name_off, n_seqs,
            l_pac};

    const int64_t n_reads = 2 * n_pairs;
    std::vector<std::vector<Reg>> regs_by_read(n_reads);
    std::vector<uint8_t> qtmp, ttmp, zbuf, qread;
    std::vector<int32_t> Hbuf, Ebuf;
    std::vector<std::vector<uint8_t>> queries(n_reads);
    {
        int64_t row = 0;
        for (int64_t i = 0; i < n_reads; ++i) {
            auto& regs = regs_by_read[i];
            while (row < n_rows && rr_read[row] < i) ++row;
            while (row < n_rows && rr_read[row] == i) {
                Reg r;
                r.rb = rr_rb[row]; r.re = rr_re[row];
                r.qb = rr_qb[row]; r.qe = rr_qe[row];
                r.rid = rr_rid[row]; r.score = rr_score[row];
                r.truesc = rr_truesc[row]; r.w = rr_w[row];
                r.seedcov = rr_seedcov[row];
                r.seedlen0 = rr_seedlen0[row];
                r.is_alt = ann_is_alt[r.rid] != 0;
                r.frac_rep = frac_rep[i];
                regs.push_back(r);
                ++row;
            }
            const int l_query = lens[i];
            const int32_t* crow = codes + i * codes_stride;
            queries[i].resize(l_query);
            for (int k = 0; k < l_query; ++k)
                queries[i][k] = (uint8_t)crow[k];
            if (!skip_dedup[i])
                sort_dedup_patch(opt, bns, ref_string,
                                 queries[i].data(), regs, qtmp, ttmp,
                                 zbuf, Hbuf, Ebuf);
        }
    }

    PeStatC pes[4];
    if (use_pes_in) {
        for (int d = 0; d < 4; ++d) {
            pes[d].low = (int64_t)pes_io[d * 5];
            pes[d].high = (int64_t)pes_io[d * 5 + 1];
            pes[d].avg = pes_io[d * 5 + 2];
            pes[d].stdv = pes_io[d * 5 + 3];
            pes[d].failed = pes_io[d * 5 + 4] != 0.0;
        }
    } else {
        pe_stat(opt, pe, l_pac, regs_by_read, n_pairs, pes);
        for (int d = 0; d < 4; ++d) {
            pes_io[d * 5] = (double)pes[d].low;
            pes_io[d * 5 + 1] = (double)pes[d].high;
            pes_io[d * 5 + 2] = pes[d].avg;
            pes_io[d * 5 + 3] = pes[d].stdv;
            pes_io[d * 5 + 4] = pes[d].failed ? 1.0 : 0.0;
        }
    }

    {
        std::vector<RescueJob> jobs;
        build_rescue_jobs(opt, pe, bns, ref_string, pes, regs_by_read,
                          codes, codes_stride, lens, n_pairs, jobs);
        run_apply_rescues(opt, bns, jobs, regs_by_read, qtmp, ttmp,
                          zbuf, Hbuf, Ebuf);
    }

    int64_t n_rec = 0, md_used = 0, xa_used = 0;
    WorkBufs wb;
    for (int64_t p = 0; p < n_pairs; ++p) {
        const int64_t pair_id = read_ids[2 * p] >> 1;
        const uint8_t* q2[2] = {queries[2 * p].data(),
                                queries[2 * p + 1].data()};
        const int lq2[2] = {lens[2 * p], lens[2 * p + 1]};
        std::vector<Reg>* regs2[2] = {&regs_by_read[2 * p],
                                      &regs_by_read[2 * p + 1]};
        PairOut po;
        if (!sam_pe_one(opt, pe, bns, ref_string, pes, pair_id, q2,
                        lq2, regs2, &po, wb))
            return -2;
        for (int i = 0; i < 2; ++i) {
            const int64_t ri = 2 * p + i;
            const AlnOut& m = po.mate[i];
            mate_rid[ri] = m.rid;
            mate_pos[ri] = m.pos;
            mate_is_rev[ri] = m.is_rev ? 1 : 0;
            int32_t rlen = 0;
            for (uint32_t c : m.cig) {
                const uint32_t op = c & 0xF;
                if (op == 0 || op == 2) rlen += (int32_t)(c >> 4);
            }
            mate_rlen[ri] = m.rid >= 0 ? rlen : 0;
            int32_t nrec_i = 0;
            for (const RecOut& ro : po.recs[i]) {
                const AlnOut& qo = ro.a;
                const std::string& xs = ro.xa;
                if (n_rec >= rec_cap
                    || (int32_t)qo.cig.size() > cig_stride)
                    return -1;
                if (md_used + (int64_t)qo.md.size() > md_cap
                    || xa_used + (int64_t)xs.size() > xa_cap)
                    return -1;
                rec_read[n_rec] = (int32_t)ri;
                rec_rid[n_rec] = qo.rid;
                rec_pos[n_rec] = qo.pos;
                rec_flag[n_rec] = qo.flag;
                rec_mapq[n_rec] = qo.mapq;
                rec_score[n_rec] = qo.score;
                rec_sub[n_rec] = qo.sub;
                rec_nm[n_rec] = qo.nm;
                rec_alt_sc[n_rec] = qo.alt_sc;
                rec_is_rev[n_rec] = qo.is_rev;
                rec_is_alt[n_rec] = qo.is_alt;
                rec_ncig[n_rec] = (int32_t)qo.cig.size();
                std::memcpy(cig_out + n_rec * cig_stride,
                            qo.cig.data(),
                            qo.cig.size() * sizeof(uint32_t));
                std::memcpy(md_arena + md_used, qo.md.data(),
                            qo.md.size());
                rec_md_off[n_rec] = md_used;
                rec_md_len[n_rec] = (int32_t)qo.md.size();
                md_used += (int64_t)qo.md.size();
                std::memcpy(xa_arena + xa_used, xs.data(), xs.size());
                rec_xa_off[n_rec] = xa_used;
                rec_xa_len[n_rec] = (int32_t)xs.size();
                xa_used += (int64_t)xs.size();
                ++nrec_i;
                ++n_rec;
            }
            rd_nrec[ri] = nrec_i;
        }
    }
    return n_rec;
}

}  // extern "C"
