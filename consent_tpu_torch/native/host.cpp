// Native host-side accelerators for consent_tpu.
//
// The reference implements its entire host path in C++ (SURVEY.md §2a);
// here the host-bound hot loops that stay off the TPU get native
// implementations, exposed via ctypes (consent_tpu/native/__init__.py),
// with NumPy fallbacks in the Python layer:
//
//   * encode_seq:       ASCII -> 2-bit codes (utils.cpp:21-32 semantics,
//                       non-ACGT -> T)
//   * revcomp:          reverse complement on codes
//   * count_kmers:      dense 4^k table accumulation over fragments
//   * polish_correction: the DBG repair pass (correctionDBG.cpp:93-205 +
//                       DBG.cpp link/extendLeft/extendRight), identical
//                       semantics to consent_tpu/core/dbg.py
//
// Build: g++ -O3 -shared -fPIC host.cpp -o libconsent_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// codec

void encode_seq(const char* seq, int64_t n, uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) table[i] = 3;  // non-ACGT -> T
        table['A'] = table['a'] = 0;
        table['C'] = table['c'] = 1;
        table['G'] = table['g'] = 2;
        table['T'] = table['t'] = 3;
        init = true;
    }
    for (int64_t i = 0; i < n; i++) out[i] = table[(uint8_t)seq[i]];
}

void revcomp(const uint8_t* codes, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = 3 - codes[n - 1 - i];
}

void count_kmers(const uint8_t* codes, const int64_t* lens,
                 const int64_t* offsets, int64_t n_frags, int k,
                 int32_t* counts /* 4^k, caller-zeroed */) {
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    for (int64_t f = 0; f < n_frags; f++) {
        const uint8_t* s = codes + offsets[f];
        int64_t n = lens[f];
        if (n < k) continue;
        uint64_t km = 0;
        for (int i = 0; i < k; i++) km = (km << 2) | s[i];
        counts[km]++;
        for (int64_t i = k; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            counts[km]++;
        }
    }
}

// count_kmers + the distinct k-mers actually touched (first-touch
// record; order unspecified).  Lets the caller build a sparse view
// without scanning the whole 4^k table — that scan dominated the host
// post-processing stage (~0.6 ms/window at k=9).  `touched` must hold
// sum(max(0, len-k+1)) entries; returns the number written.
int64_t count_kmers_touched(const uint8_t* codes, const int64_t* lens,
                            const int64_t* offsets, int64_t n_frags,
                            int k, int32_t* counts /* 4^k, zeroed */,
                            int64_t* touched) {
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int64_t nt = 0;
    for (int64_t f = 0; f < n_frags; f++) {
        const uint8_t* s = codes + offsets[f];
        int64_t n = lens[f];
        if (n < k) continue;
        uint64_t km = 0;
        for (int i = 0; i < k; i++) km = (km << 2) | s[i];
        if (counts[km]++ == 0) touched[nt++] = (int64_t)km;
        for (int64_t i = k; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            if (counts[km]++ == 0) touched[nt++] = (int64_t)km;
        }
    }
    return nt;
}

// ---------------------------------------------------------------------------
// DBG repair (semantics of consent_tpu/core/dbg.py == reference
// correctionDBG.cpp/DBG.cpp; see the Python module for the behavioral
// notes)

namespace {

struct Dbg {
    const int32_t* counts;
    int k;
    int solid;
    uint64_t mask;

    int neighbors_right(uint64_t km, uint64_t* out) const {
        uint64_t base = (km << 2) & mask;
        int32_t c[4];
        uint64_t n[4];
        int cnt = 0;
        for (int b = 0; b < 4; b++) {
            uint64_t x = base | (uint64_t)b;
            int32_t v = counts[x];
            if (v >= solid) { c[cnt] = v; n[cnt] = x; cnt++; }
        }
        // stable sort desc by count (tiny arrays)
        for (int i = 1; i < cnt; i++)
            for (int j = i; j > 0 && c[j] > c[j - 1]; j--) {
                std::swap(c[j], c[j - 1]);
                std::swap(n[j], n[j - 1]);
            }
        for (int i = 0; i < cnt; i++) out[i] = n[i];
        return cnt;
    }

    int neighbors_left(uint64_t km, uint64_t* out) const {
        uint64_t base = km >> 2;
        int shift = 2 * (k - 1);
        int32_t c[4];
        uint64_t n[4];
        int cnt = 0;
        // generation order T,G,C,A (reference's revcomp gymnastics)
        for (int b = 3; b >= 0; b--) {
            uint64_t x = base | ((uint64_t)b << shift);
            int32_t v = counts[x];
            if (v >= solid) { c[cnt] = v; n[cnt] = x; cnt++; }
        }
        for (int i = 1; i < cnt; i++)
            for (int j = i; j > 0 && c[j] > c[j - 1]; j--) {
                std::swap(c[j], c[j - 1]);
                std::swap(n[j], n[j - 1]);
            }
        for (int i = 0; i < cnt; i++) out[i] = n[i];
        return cnt;
    }
};

uint64_t codes_to_kmer(const uint8_t* c, int k) {
    uint64_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 2) | c[i];
    return v;
}

// bounded DFS from src to dst; path codes appended to cur (starts with
// src's k codes); returns true and leaves the path in cur on success.
bool link_dfs(const Dbg& g, uint64_t dst, std::unordered_set<uint64_t>& visited,
              int& branches, int dist, std::vector<uint8_t>& cur,
              int max_size, int max_branches) {
    if (branches > max_branches || dist > max_size) return false;
    uint64_t anchor = 0;
    for (int i = 0; i < g.k; i++)
        anchor = (anchor << 2) | cur[cur.size() - g.k + i];
    if (anchor == dst) return true;

    uint64_t neigh[4];
    int cnt = g.neighbors_right(anchor, neigh);
    int it = 0;
    // greedy while unbranched
    while (cnt == 1 && it < cnt && dist <= max_size) {
        uint64_t nx = neigh[it];
        if (nx == dst) { cur.push_back((uint8_t)(nx & 3)); return true; }
        if (!visited.count(nx)) {
            visited.insert(nx);
            cur.push_back((uint8_t)(nx & 3));
            dist++;
            cnt = g.neighbors_right(nx, neigh);
            it = 0;
        } else {
            it++;
        }
    }
    // branch exploration with backtracking
    while (cnt > 1 && it < cnt && dist <= max_size) {
        uint64_t nx = neigh[it];
        if (nx == dst) { cur.push_back((uint8_t)(nx & 3)); return true; }
        if (!visited.count(nx)) {
            visited.insert(nx);
            branches++;
            size_t mark = cur.size();
            cur.push_back((uint8_t)(nx & 3));
            if (link_dfs(g, dst, visited, branches, dist + 1, cur,
                         max_size, max_branches))
                return true;
            cur.resize(mark);
            it++;
        } else {
            it++;
        }
    }
    return false;
}

int next_src(const uint8_t* solid, int len, int beg, int n) {
    int nb = 0, i = beg;
    while (i < len && (solid[i] || nb < n)) {
        nb = solid[i] ? nb + 1 : 0;
        i++;
    }
    return nb >= n ? i - 1 : -1;
}

int next_dst(const uint8_t* solid, int len, int beg, int n) {
    int nb = 0, i = beg;
    while (i < len && nb < n) {
        nb = solid[i] ? nb + 1 : 0;
        i++;
    }
    return nb >= n ? i - 1 : -1;
}

struct Anchor {
    uint64_t skm, dkm;
    int spos, dpos;
    int64_t score;
};

}  // namespace

// Returns output length, or -1 if out_cap is too small.
int64_t polish_correction(
    const uint8_t* in_codes, const uint8_t* in_solid, int64_t in_len,
    const int32_t* counts, int k, int solid_thresh,
    int max_branches, int zone,
    uint8_t* out_codes, uint8_t* out_solid, int64_t out_cap) {
    const int ZONE = zone, MAX_BRANCHES = max_branches, ANCHORS_NB = 5;
    Dbg g{counts, k, solid_thresh,
          (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1)};

    std::vector<uint8_t> codes(in_codes, in_codes + in_len);
    std::vector<uint8_t> solid(in_solid, in_solid + in_len);
    std::unordered_set<uint64_t> visited;
    int64_t tmp_src_beg = 0, tmp_src_end = 0, tmp_dst_beg = 0,
            tmp_dst_end = 0;

    // ---- weak head extension ----
    int64_t L = (int64_t)codes.size();
    int64_t i = 0;
    while (i < L && !solid[i]) i++;
    if (i > 0 && i < L && L - i >= k) {
        int ext_len = (int)i;
        std::vector<uint8_t> trimmed_c(codes.begin() + i, codes.end());
        std::vector<uint8_t> trimmed_s(solid.begin() + i, solid.end());
        // extend left while the path is unique
        std::vector<uint8_t> ext;
        uint64_t km = codes_to_kmer(trimmed_c.data(), k);
        int dist = 0;
        uint64_t neigh[4];
        int cnt = g.neighbors_left(km, neigh);
        while (cnt == 1 && dist < ext_len) {
            km = neigh[0];
            ext.push_back((uint8_t)((km >> (2 * (k - 1))) & 3));
            dist++;
            cnt = g.neighbors_left(km, neigh);
        }
        std::vector<uint8_t> nc, ns;
        if (dist < ext_len) {
            int keep = ext_len - dist;
            nc.insert(nc.end(), codes.begin(), codes.begin() + keep);
            ns.insert(ns.end(), solid.begin(), solid.begin() + keep);
            i = i - keep;
        }
        for (auto it = ext.rbegin(); it != ext.rend(); ++it) {
            nc.push_back(*it);
            ns.push_back(1);
        }
        nc.insert(nc.end(), trimmed_c.begin(), trimmed_c.end());
        ns.insert(ns.end(), trimmed_s.begin(), trimmed_s.end());
        codes.swap(nc);
        solid.swap(ns);
    }

    // ---- interior weak regions ----
    L = (int64_t)codes.size();
    while (i < L) {
        int src_end = next_src(solid.data(), (int)L, (int)i, k + ZONE);
        int dst_end = src_end != -1
                          ? next_dst(solid.data(), (int)L, src_end + 1,
                                     k + ZONE)
                          : -1;
        if (src_end == -1 || dst_end == -1) break;
        int src_beg = src_end - (k + ZONE) + 1;
        int dst_beg = dst_end - (k + ZONE) + 1;

        // anchors: unique k-mers of each zone, paired, ranked
        std::vector<Anchor> anchors;
        {
            const int zn = k + ZONE - k + 1;  // k-mers per zone
            std::vector<uint64_t> skm(zn), dkm(zn);
            std::vector<int> scnt(zn, 0), dcnt(zn, 0);
            for (int p = 0; p < zn; p++) {
                skm[p] = codes_to_kmer(codes.data() + src_beg + p, k);
                dkm[p] = codes_to_kmer(codes.data() + dst_beg + p, k);
            }
            for (int p = 0; p < zn; p++)
                for (int q = 0; q < zn; q++) {
                    if (skm[q] == skm[p]) scnt[p]++;
                    if (dkm[q] == dkm[p]) dcnt[p]++;
                }
            std::vector<Anchor> all;
            for (int p = 0; p < zn; p++) {
                if (scnt[p] != 1) continue;
                for (int q = 0; q < zn; q++) {
                    if (dcnt[q] != 1) continue;
                    all.push_back(
                        {skm[p], dkm[q], p, q,
                         (int64_t)counts[skm[p]] + counts[dkm[q]]});
                }
            }
            // stable sort desc by score
            for (size_t a = 1; a < all.size(); a++)
                for (size_t b = a;
                     b > 0 && all[b].score > all[b - 1].score; b--)
                    std::swap(all[b], all[b - 1]);
            for (size_t a = 0; a < all.size() && a < ANCHORS_NB; a++)
                anchors.push_back(all[a]);
        }

        bool found = false;
        std::vector<uint8_t> region;
        for (const Anchor& an : anchors) {
            if (found) break;
            tmp_src_beg = src_beg + an.spos;
            tmp_src_end = tmp_src_beg + k - 1;
            tmp_dst_beg = dst_beg + an.dpos;
            tmp_dst_end = tmp_dst_beg + k - 1;
            if (an.skm != an.dkm) {
                int64_t gap = tmp_dst_beg - tmp_src_end - 1;
                int max_size = (int)(15.0 / 100.0 * 2.0 * gap + gap + k);
                int branches = 0;
                region.assign(codes.begin() + tmp_src_beg,
                              codes.begin() + tmp_src_end + 1);
                found = link_dfs(g, an.dkm, visited, branches, 0, region,
                                 max_size, MAX_BRANCHES);
            }
        }

        if (found) {
            // first occurrence of the (codes, solid) pattern
            int64_t plen = tmp_dst_end - tmp_src_beg + 1;
            int64_t b = -1;
            for (int64_t p = 0; p + plen <= L; p++) {
                bool eq = true;
                for (int64_t x = 0; x < plen && eq; x++) {
                    eq = codes[p + x] == codes[tmp_src_beg + x] &&
                         solid[p + x] == solid[tmp_src_beg + x];
                }
                if (eq) { b = p; break; }
            }
            if (b != -1) {
                std::vector<uint8_t> nc, ns;
                nc.reserve(L + region.size());
                nc.insert(nc.end(), codes.begin(), codes.begin() + b);
                nc.insert(nc.end(), region.begin(), region.end());
                nc.insert(nc.end(), codes.begin() + b + plen, codes.end());
                ns.insert(ns.end(), solid.begin(), solid.begin() + b);
                ns.insert(ns.end(), region.size(), 1);
                ns.insert(ns.end(), solid.begin() + b + plen, solid.end());
                codes.swap(nc);
                solid.swap(ns);
                L = (int64_t)codes.size();
                i = b;
            } else {
                i = tmp_dst_beg > i ? tmp_dst_beg : dst_beg;
            }
        } else {
            i = tmp_dst_beg > i ? tmp_dst_beg : dst_beg;
        }
    }

    // ---- weak tail extension ----
    L = (int64_t)codes.size();
    i = L - 1;
    while (i > 0 && !solid[i]) i--;
    if (i > 0 && i < L - 1 && i + 1 >= k) {
        int ext_len = (int)(L - 1 - i);
        std::vector<uint8_t> old_c = codes, old_s = solid;
        codes.resize(i + 1);
        solid.resize(i + 1);
        // extend right following the best neighbor (branching or not)
        uint64_t km = codes_to_kmer(codes.data() + codes.size() - k, k);
        int dist = 0;
        uint64_t neigh[4];
        int cnt = g.neighbors_right(km, neigh);
        while (cnt > 0 && dist < ext_len) {
            km = neigh[0];
            codes.push_back((uint8_t)(km & 3));
            solid.push_back(1);
            dist++;
            cnt = g.neighbors_right(km, neigh);
        }
        if (dist < ext_len) {
            int keep = ext_len - dist;
            codes.insert(codes.end(), old_c.end() - keep, old_c.end());
            solid.insert(solid.end(), old_s.end() - keep, old_s.end());
        }
    }

    if ((int64_t)codes.size() > out_cap) return -1;
    std::memcpy(out_codes, codes.data(), codes.size());
    std::memcpy(out_solid, solid.data(), solid.size());
    return (int64_t)codes.size();
}

}  // extern "C"

extern "C" int64_t local_align_span(
    const uint8_t* q, int64_t lq, const uint8_t* r, int64_t lr,
    int match, int mismatch, int gap_open, int gap_ext, int64_t* out);

// ---------------------------------------------------------------------------
// One stitch apply step (pipeline/stitch.py StitchJob.apply, reference
// alignConsensus splice loop, correctionAlignment.cpp:79-135): overlap
// arbitration by solid k-mer counts (+ the reference's min(len1,len2)
// ref-clamped sub-alignment, :110) and the window splice, in one
// native call.  The per-window numpy glue (kmer_codes + searchsorted +
// concatenate) dominated stitch.apply under the host pools.

namespace {

// occurrences of seq's k-mers with count >= thresh in a sorted
// (keys, vals) table — SparseCounts.n_solid semantics (multiplicity
// counted per occurrence)
int64_t n_solid_kmers(const uint8_t* seq, int64_t n, int k,
                      const int64_t* keys, const int32_t* vals,
                      int64_t n_keys, int thresh) {
    if (n < k || n_keys == 0) return 0;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t km = 0;
    for (int i = 0; i < k - 1; i++) km = (km << 2) | seq[i];
    int64_t cnt = 0;
    for (int64_t p = 0; p + k <= n; p++) {
        km = ((km << 2) | seq[p + k - 1]) & mask;
        const int64_t* it =
            std::lower_bound(keys, keys + n_keys, (int64_t)km);
        if (it != keys + n_keys && *it == (int64_t)km &&
            vals[it - keys] >= thresh)
            cnt++;
    }
    return cnt;
}

}  // namespace

// out_meta: [0]=new out length (-1 if cap too small), [1]=spliced cur
// length, [2]=new old_end, [3]=track flag actually applied (0/1).
extern "C" void stitch_apply_step(
    const uint8_t* out_c, const uint8_t* out_s, int64_t cur_len,
    const uint8_t* cons_c, const uint8_t* cons_s, int64_t cons_n,
    int64_t raw_cons_len,
    int64_t q_begin, int64_t q_end, int64_t r_begin, int64_t r_end,
    int64_t al_pos, int64_t i_window, int64_t old_end,
    const uint8_t* old_c, const uint8_t* old_s, int64_t old_len,
    int64_t has_old,
    const int64_t* old_keys, const int32_t* old_vals, int64_t n_old,
    const int64_t* cur_keys, const int32_t* cur_vals, int64_t n_cur,
    int k, int solid_thresh,
    int match, int mismatch, int gap_open, int gap_ext,
    int64_t track_old,
    uint8_t* new_out_c, uint8_t* new_out_s, int64_t out_cap,
    uint8_t* new_cur_c, uint8_t* new_cur_s, int64_t cur_cap,
    int64_t* out_meta) {
    const int64_t beg = r_begin + al_pos;
    const int64_t end = r_end + al_pos;
    // cur = cons[q_begin..q_end]
    std::vector<uint8_t> cur(cons_c + q_begin, cons_c + q_end + 1);
    std::vector<uint8_t> curs(cons_s + q_begin, cons_s + q_end + 1);

    // ---- overlap arbitration with the previous window ----
    if (i_window != 0 && old_end >= beg && has_old) {
        const int64_t overlap = old_end - beg + 1;
        if (raw_cons_len >= k && old_len >= overlap &&
            (int64_t)cur.size() >= overlap) {
            const uint8_t* s1 = old_c + (old_len - overlap);
            const uint8_t* s1s = old_s + (old_len - overlap);
            if (memcmp(s1, cur.data(), overlap) != 0) {
                int64_t sm1, sm2;
                if (overlap >= k) {
                    sm1 = n_solid_kmers(s1, overlap, k, old_keys,
                                        old_vals, n_old, solid_thresh);
                    sm2 = n_solid_kmers(cur.data(), overlap, k,
                                        cur_keys, cur_vals, n_cur,
                                        solid_thresh);
                } else {
                    sm1 = 0;
                    for (int64_t i = 0; i < overlap; i++) sm1 += s1s[i];
                    sm2 = 0;
                    for (int64_t i = 0; i < overlap; i++)
                        sm2 += curs[i];
                }
                if (sm1 > sm2) {
                    // keep the previous window's overlap; the
                    // reference clamps the ref side to min(len1,len2)
                    // (correctionAlignment.cpp:110)
                    int64_t sub[7];
                    local_align_span(s1, overlap, cur.data(), overlap,
                                     match, mismatch, gap_open,
                                     gap_ext, sub);
                    const int64_t cut = overlap - sub[5] + sub[6];
                    if (cut < (int64_t)cur.size()) {
                        std::vector<uint8_t> nc(s1, s1 + overlap);
                        nc.insert(nc.end(), cur.begin() + cut,
                                  cur.end());
                        std::vector<uint8_t> ns(s1s, s1s + overlap);
                        ns.insert(ns.end(), curs.begin() + cut,
                                  curs.end());
                        cur.swap(nc);
                        curs.swap(ns);
                    } else {
                        cur.clear();
                        curs.clear();
                    }
                }
            }
        }
    }

    // ---- splice ----
    int64_t new_len = cur_len;
    int64_t spliced = (int64_t)cur.size();
    int64_t new_old_end = old_end;
    int64_t tracked = 0;
    int64_t modified = 0;
    if (!cur.empty()) {
        if (raw_cons_len >= k) {
            new_len = beg + (int64_t)cur.size() + (cur_len - end - 1);
            if (new_len > out_cap || spliced > cur_cap) {
                out_meta[0] = -1;
                return;
            }
            memcpy(new_out_c, out_c, beg);
            memcpy(new_out_c + beg, cur.data(), cur.size());
            memcpy(new_out_c + beg + cur.size(), out_c + end + 1,
                   cur_len - end - 1);
            memcpy(new_out_s, out_s, beg);
            memset(new_out_s + beg, 1, cur.size());
            memcpy(new_out_s + beg + cur.size(), out_s + end + 1,
                   cur_len - end - 1);
            modified = 1;
        }
        if (track_old) {
            if (spliced > cur_cap) {
                out_meta[0] = -1;
                return;
            }
            memcpy(new_cur_c, cur.data(), cur.size());
            memcpy(new_cur_s, curs.data(), curs.size());
            new_old_end = beg + (int64_t)cur.size() - 1;
            tracked = 1;
        }
    }
    out_meta[0] = new_len;
    out_meta[1] = spliced;
    out_meta[2] = new_old_end;
    out_meta[3] = tracked;
    out_meta[4] = modified;
}

// ---------------------------------------------------------------------------
// affine-gap local alignment with traceback (host-side small alignments:
// the stitcher's overlap arbitration, reference correctionAlignment.cpp:110)
// Same semantics as consent_tpu/core/npalign.py.

extern "C" int64_t local_align_span(
    const uint8_t* q, int64_t lq, const uint8_t* r, int64_t lr,
    int match, int mismatch, int gap_open, int gap_ext,
    int64_t* out /* opt,qb,qe,rb,re,n_ins,n_del */) {
    const int64_t NEGV = -(1LL << 40);
    if (lq == 0 || lr == 0) {
        out[0] = 0; out[1] = 0; out[2] = -1; out[3] = 0; out[4] = -1;
        out[5] = 0; out[6] = 0;
        return 0;
    }
    std::vector<int64_t> H((lq + 1) * (lr + 1), 0);
    std::vector<int64_t> E((lq + 1) * (lr + 1), NEGV);
    std::vector<int64_t> F((lq + 1) * (lr + 1), NEGV);
    auto idx = [&](int64_t i, int64_t j) { return i * (lr + 1) + j; };
    int64_t opt = 0, oi = 0, oj = 0;
    for (int64_t i = 1; i <= lq; i++) {
        for (int64_t j = 1; j <= lr; j++) {
            int64_t e = std::max(H[idx(i, j - 1)] - gap_open,
                                 E[idx(i, j - 1)] - gap_ext);
            int64_t f = std::max(H[idx(i - 1, j)] - gap_open,
                                 F[idx(i - 1, j)] - gap_ext);
            int64_t sub = (q[i - 1] == r[j - 1]) ? match : mismatch;
            int64_t h = std::max<int64_t>(
                0, std::max(H[idx(i - 1, j - 1)] + sub, std::max(e, f)));
            E[idx(i, j)] = e;
            F[idx(i, j)] = f;
            H[idx(i, j)] = h;
            if (h > opt) { opt = h; oi = i; oj = j; }
        }
    }
    if (opt == 0) {
        out[0] = 0; out[1] = 0; out[2] = -1; out[3] = 0; out[4] = -1;
        out[5] = 0; out[6] = 0;
        return 0;
    }
    // traceback (mirrors npalign.local_align)
    int64_t i = oi, j = oj, n_ins = 0, n_del = 0;
    int64_t qb = -1, qe = -1, rb = -1, re = -1;
    int state = 0;  // 0=H,1=E,2=F
    while (H[idx(i, j)] > 0 || state != 0) {
        if (state == 0) {
            int64_t sub = (q[i - 1] == r[j - 1]) ? match : mismatch;
            if (H[idx(i, j)] == H[idx(i - 1, j - 1)] + sub) {
                if (qe < 0) { qe = i - 1; re = j - 1; }
                qb = i - 1; rb = j - 1;
                i--; j--;
            } else if (H[idx(i, j)] == E[idx(i, j)]) {
                state = 1;
            } else if (H[idx(i, j)] == F[idx(i, j)]) {
                state = 2;
            } else {
                break;
            }
        } else if (state == 1) {
            n_del++;
            if (E[idx(i, j)] == E[idx(i, j - 1)] - gap_ext) {
                j--;
            } else {
                j--; state = 0;
            }
        } else {
            n_ins++;
            if (F[idx(i, j)] == F[idx(i - 1, j)] - gap_ext) {
                i--;
            } else {
                i--; state = 0;
            }
        }
    }
    out[0] = opt; out[1] = qb; out[2] = qe; out[3] = rb; out[4] = re;
    out[5] = n_ins; out[6] = n_del;
    return opt;
}

// ---------------------------------------------------------------------------
// MSA give-up gate (reference: BMEAN anchor scan feeding
// correctionMSA.cpp:31-36 — bmeanSup = min(commonKMers, piles/2); fewer
// than minAnchors anchors => consensus gives up, raw template kept).
// An anchor here: a k-mer occurring exactly once in the template and
// exactly once in each of >= `support` window sequences (template
// included).  Uses a generation-stamped dense table so repeated calls
// never re-clear the 4^k arrays.

extern "C" int64_t count_anchors(const uint8_t* codes, const int64_t* lens,
                      const int64_t* offsets, int64_t n_seqs, int k,
                      int support) {
    if (n_seqs <= 0) return 0;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int64_t table_n = (int64_t)1 << (2 * k);
    static thread_local std::vector<int32_t> gen, occ, share;
    static thread_local int32_t generation = 0;
    static thread_local std::vector<int32_t> sgen;
    if ((int64_t)gen.size() != table_n) {
        gen.assign(table_n, -1);
        occ.assign(table_n, 0);
        share.assign(table_n, 0);
        sgen.assign(table_n, -1);
        generation = 0;
    }

    // per sequence: mark k-mers occurring exactly once, bump share count
    int32_t sg = generation;  // share-generation for this call
    for (int64_t f = 0; f < n_seqs; f++) {
        generation++;
        const uint8_t* s = codes + offsets[f];
        int64_t n = lens[f];
        if (n < k) continue;
        uint64_t km = 0;
        for (int i = 0; i < k - 1; i++) km = (km << 2) | s[i];
        for (int64_t i = k - 1; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            if (gen[km] != generation) { gen[km] = generation; occ[km] = 0; }
            occ[km]++;
        }
        // second pass over this sequence's distinct k-mers
        km = 0;
        for (int i = 0; i < k - 1; i++) km = (km << 2) | s[i];
        for (int64_t i = k - 1; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            if (occ[km] == 1) {
                if (sgen[km] != sg) { sgen[km] = sg; share[km] = 0; }
                share[km]++;
                occ[km] = -1;  // count each distinct k-mer once per seq
            }
        }
    }

    // anchors: template (sequence 0) k-mers unique in the template and
    // shared (exactly-once) by >= support sequences (template included)
    int64_t n_anchors = 0;
    const uint8_t* t = codes + offsets[0];
    int64_t tn = lens[0];
    if (tn < k) { generation += 1; return 0; }
    generation++;
    uint64_t km = 0;
    for (int i = 0; i < k - 1; i++) km = (km << 2) | t[i];
    for (int64_t i = k - 1; i < tn; i++) {
        km = ((km << 2) | t[i]) & mask;
        if (gen[km] != generation) { gen[km] = generation; occ[km] = 0; }
        occ[km]++;
    }
    km = 0;
    for (int i = 0; i < k - 1; i++) km = (km << 2) | t[i];
    for (int64_t i = k - 1; i < tn; i++) {
        km = ((km << 2) | t[i]) & mask;
        if (occ[km] != 1) continue;  // repeated in template, or judged
        occ[km] = -2;
        if (sgen[km] == sg && share[km] >= support) n_anchors++;
    }
    generation++;
    return n_anchors;
}

// ---------------------------------------------------------------------------
// consolidated per-window host post chain + batch consensus assembly
//
// One ctypes call per window (resp. per batch) instead of ~6: the
// Python/ctypes/numpy glue between the tiny native stages dominated
// consensus.kmer_dbg under the 2-core host pools.

extern "C" {

// Whole host post chain of one window: k-mer counts (+ distinct-kmer
// record) -> anchor give-up gate (correctionMSA.cpp:31-36) ->
// solidity case channel (weightConsensus, correctionMSA.cpp:6-27) ->
// DBG polish (correctionDBG.cpp:93-205).
//
// frags: template-first fragment blob.  dense: 4^k int32, caller-
// zeroed.  touched: distinct-kmer out array (cap sum(len-k+1)).
// status out: 0 polished, 1 anchor-gate template fallback (all-solid
// template copied out), 2 consensus shorter than k (all-weak copy).
// Returns the output length, or -1 if out_cap is too small.
int64_t host_post_window(
    const uint8_t* frag_blob, const int64_t* lens,
    const int64_t* offsets, int64_t n_frags,
    const uint8_t* cons, int64_t cons_len,
    int k, int solid_thresh, int max_branches, int zone,
    int min_anchors, int bmean_sup,
    int32_t* dense, int64_t* touched, int64_t* n_touched,
    uint8_t* out_codes, uint8_t* out_solid, int64_t out_cap,
    int32_t* status) {
    *n_touched = count_kmers_touched(frag_blob, lens, offsets, n_frags,
                                     k, dense, touched);
    int64_t n_anch = count_anchors(frag_blob, lens, offsets, n_frags,
                                   k, bmean_sup);
    if (n_anch < min_anchors) {
        // template fallback, all-solid (reference returns piles[0],
        // an uppercase string)
        int64_t tn = lens[0];
        if (tn > out_cap) return -1;
        memcpy(out_codes, frag_blob + offsets[0], tn);
        memset(out_solid, 1, tn);
        *status = 1;
        return tn;
    }
    if (cons_len < k) {
        if (cons_len > out_cap) return -1;
        memcpy(out_codes, cons, cons_len);
        memset(out_solid, 0, cons_len);
        *status = 2;
        return cons_len;
    }
    // solidity mask: mask[p] = solid(kmer starting at min(p, L-k))
    std::vector<uint8_t> solid(cons_len);
    {
        const uint64_t mask = (k >= 32) ? ~0ULL
                                        : ((1ULL << (2 * k)) - 1);
        uint64_t km = 0;
        for (int i = 0; i < k - 1; i++) km = (km << 2) | cons[i];
        for (int64_t p = 0; p + k <= cons_len; p++) {
            km = ((km << 2) | cons[p + k - 1]) & mask;
            solid[p] = dense[km] >= solid_thresh;
        }
        for (int64_t p = cons_len - k + 1; p < cons_len; p++)
            solid[p] = solid[cons_len - k];
    }
    *status = 0;
    return polish_correction(cons, solid.data(), cons_len, dense, k,
                             solid_thresh, max_branches, zone,
                             out_codes, out_solid, out_cap);
}

// Fused single-sweep variant of count_kmers_touched + count_anchors:
// one pass over the fragment k-mer stream feeds the global dense
// table AND the per-sequence exactly-once bookkeeping the anchor gate
// needs (count_anchors alone re-streamed every fragment twice — it
// was ~a third of the non-DBG host post).  Bit-equal outputs.
static int64_t count_kmers_touched_anchors(
    const uint8_t* codes, const int64_t* lens, const int64_t* offsets,
    int64_t n_seqs, int k, int support,
    int32_t* dense /* 4^k, zeroed */, int64_t* touched,
    int64_t* n_anchors_out) {
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int64_t table_n = (int64_t)1 << (2 * k);
    static thread_local std::vector<int32_t> gen, occ, share, sgen;
    static thread_local int32_t generation = 0;
    static thread_local std::vector<int64_t> tpl_unique;
    if ((int64_t)gen.size() != table_n) {
        gen.assign(table_n, -1);
        occ.assign(table_n, 0);
        share.assign(table_n, 0);
        sgen.assign(table_n, -1);
        generation = 0;
    }
    tpl_unique.clear();
    const int32_t sg = generation;
    int64_t nt = 0;
    for (int64_t f = 0; f < n_seqs; f++) {
        generation++;
        const uint8_t* s = codes + offsets[f];
        const int64_t n = lens[f];
        if (n < k) continue;
        uint64_t km = 0;
        for (int i = 0; i < k - 1; i++) km = (km << 2) | s[i];
        for (int64_t i = k - 1; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            if (dense[km]++ == 0) touched[nt++] = (int64_t)km;
            if (gen[km] != generation) {
                gen[km] = generation;
                occ[km] = 0;
            }
            occ[km]++;
        }
        // distinct exactly-once k-mers of this sequence
        km = 0;
        for (int i = 0; i < k - 1; i++) km = (km << 2) | s[i];
        for (int64_t i = k - 1; i < n; i++) {
            km = ((km << 2) | s[i]) & mask;
            if (occ[km] == 1) {
                if (sgen[km] != sg) { sgen[km] = sg; share[km] = 0; }
                share[km]++;
                occ[km] = -1;  // each distinct k-mer once per seq
                if (f == 0) tpl_unique.push_back((int64_t)km);
            }
        }
    }
    generation++;  // keep share-generations disjoint across calls
    int64_t n_anchors = 0;
    for (int64_t km : tpl_unique)
        if (share[km] >= support) n_anchors++;
    *n_anchors_out = n_anchors;
    return nt;
}

// Batched host post chain: MANY windows per ctypes call.  The
// per-window Python/numpy/ctypes glue around host_post_window (1 MB
// dense-table zeroing, per-window blob concatenation, np.sort of the
// touched keys) dominated consensus.kmer_dbg on small hosts; this
// entry runs a whole window slice in one call against a persistent
// thread-local dense table that is kept all-zero by re-zeroing only
// the touched k-mers after each window.
//
// Layout: one fragment blob for the slice with per-fragment
// lens/offsets and per-window ranges win_frag_off[w]..win_frag_off[w+1];
// consensus codes concatenated in cons_blob with cons_off[n_win+1].
// Outputs: corrected codes/solid blobs (out_off[n_win+1]), per-window
// SORTED distinct k-mers + their counts (keys_off[n_win+1]), status
// codes as in host_post_window.  Returns total output bytes, or -1 if
// out_cap / keys_cap is too small.
int64_t host_post_batch(
    const uint8_t* frag_blob, const int64_t* lens,
    const int64_t* offsets, const int64_t* win_frag_off,
    int64_t n_win,
    const uint8_t* cons_blob, const int64_t* cons_off,
    int k, int solid_thresh, int max_branches, int zone,
    int min_anchors, const int32_t* bmean_sup,
    uint8_t* out_codes, uint8_t* out_solid, int64_t out_cap,
    int64_t* out_off,
    int64_t* keys_out, int32_t* vals_out, int64_t keys_cap,
    int64_t* keys_off,
    int32_t* status) {
    const int64_t table_n = (int64_t)1 << (2 * k);
    static thread_local std::vector<int32_t> dense;
    if ((int64_t)dense.size() != table_n) dense.assign(table_n, 0);
    static thread_local std::vector<int64_t> touched;

    int64_t out_pos = 0, keys_pos = 0;
    out_off[0] = 0;
    keys_off[0] = 0;
    for (int64_t w = 0; w < n_win; w++) {
        const int64_t f0 = win_frag_off[w], f1 = win_frag_off[w + 1];
        const int64_t n_frags = f1 - f0;
        const uint8_t* cons = cons_blob + cons_off[w];
        const int64_t cons_len = cons_off[w + 1] - cons_off[w];
        if (n_frags <= 0) {
            status[w] = 1;
            out_off[w + 1] = out_pos;
            keys_off[w + 1] = keys_pos;
            continue;
        }
        int64_t t_cap = 0;
        for (int64_t f = f0; f < f1; f++)
            if (lens[f] >= k) t_cap += lens[f] - k + 1;
        if ((int64_t)touched.size() < t_cap) touched.resize(t_cap);
        int64_t n_anch = 0;
        const int64_t nt = count_kmers_touched_anchors(
            frag_blob, lens + f0, offsets + f0, n_frags, k,
            bmean_sup[w], dense.data(), touched.data(), &n_anch);
        // keys are 2k-bit (k <= 15); LSD radix in 10-bit digits is
        // ~10x std::sort at the typical ~10k distinct k-mers/window
        // (the sort was the single largest slice of the host post)
        {
            static thread_local std::vector<int64_t> tmp;
            if ((int64_t)tmp.size() < nt) tmp.resize(nt);
            int digits = (2 * k + 9) / 10;
            int32_t cnt10[1024];
            int64_t* src = touched.data();
            int64_t* dst = tmp.data();
            for (int d = 0; d < digits; d++) {
                memset(cnt10, 0, sizeof(cnt10));
                const int sh = 10 * d;
                for (int64_t i = 0; i < nt; i++)
                    cnt10[(src[i] >> sh) & 1023]++;
                int32_t pos = 0;
                for (int b = 0; b < 1024; b++) {
                    int32_t c = cnt10[b];
                    cnt10[b] = pos;
                    pos += c;
                }
                for (int64_t i = 0; i < nt; i++)
                    dst[cnt10[(src[i] >> sh) & 1023]++] = src[i];
                std::swap(src, dst);
            }
            if (src != touched.data())
                memcpy(touched.data(), src, nt * sizeof(int64_t));
        }
        if (keys_pos + nt > keys_cap) return -1;
        for (int64_t i = 0; i < nt; i++) {
            keys_out[keys_pos + i] = touched[i];
            vals_out[keys_pos + i] = dense[touched[i]];
        }
        keys_pos += nt;
        keys_off[w + 1] = keys_pos;

        int64_t n = -1;
        if (n_anch < min_anchors) {
            // template fallback, all-solid (correctionMSA.cpp:31-36)
            const int64_t tn = lens[f0];
            if (out_pos + tn > out_cap) n = -1;
            else {
                memcpy(out_codes + out_pos, frag_blob + offsets[f0], tn);
                memset(out_solid + out_pos, 1, tn);
                status[w] = 1;
                n = tn;
            }
        } else if (cons_len < k) {
            if (out_pos + cons_len > out_cap) n = -1;
            else {
                memcpy(out_codes + out_pos, cons, cons_len);
                memset(out_solid + out_pos, 0, cons_len);
                status[w] = 2;
                n = cons_len;
            }
        } else {
            // solidity mask: mask[p] = solid(kmer @ min(p, L-k))
            std::vector<uint8_t> solid(cons_len);
            const uint64_t mask = (k >= 32) ? ~0ULL
                                            : ((1ULL << (2 * k)) - 1);
            uint64_t km = 0;
            for (int i = 0; i < k - 1; i++) km = (km << 2) | cons[i];
            for (int64_t p = 0; p + k <= cons_len; p++) {
                km = ((km << 2) | cons[p + k - 1]) & mask;
                solid[p] = dense[km] >= solid_thresh;
            }
            for (int64_t p = cons_len - k + 1; p < cons_len; p++)
                solid[p] = solid[cons_len - k];
            status[w] = 0;
            n = polish_correction(
                cons, solid.data(), cons_len, dense.data(), k,
                solid_thresh, max_branches, zone,
                out_codes + out_pos, out_solid + out_pos,
                out_cap - out_pos);
        }
        // keep the persistent table all-zero for the next window
        for (int64_t i = 0; i < nt; i++) dense[touched[i]] = 0;
        if (n < 0) return -1;
        out_pos += n;
        out_off[w + 1] = out_pos;
    }
    return out_pos;
}

// Batch consensus assembly from the wire-format packed votes
// (ops/consensus.py assemble_consensus_batch semantics).  Two-pass:
// offsets out in out_offsets[B+1]; returns total bytes, or -1 if
// out_cap is too small.
int64_t assemble_windows(
    const int8_t* col_base, const int8_t* col_del,
    const uint8_t* ins_len, const int32_t* ins_pack,
    const int32_t* pre_len, const int32_t* pre_pack,
    const int32_t* suf_len, const int32_t* suf_pack,
    const int32_t* w_lens, int64_t B, int64_t W,
    uint8_t* out, int64_t out_cap, int64_t* out_offsets) {
    int64_t total = 0;
    for (int64_t b = 0; b < B; b++) {
        out_offsets[b] = total;
        // clamp to the arrays' row width: the C ABI takes untrusted
        // lengths and the caller's capacity math uses min(wl, W)
        int64_t wl = w_lens[b] < W ? w_lens[b] : W;
        const int8_t* cd = col_del + b * W;
        const uint8_t* il = ins_len + b * W;
        int64_t n = pre_len[b] + suf_len[b];
        for (int64_t j = 0; j < wl; j++) n += (cd[j] ? 0 : 1) + il[j];
        total += n;
    }
    out_offsets[B] = total;
    if (total > out_cap) return -1;
    for (int64_t b = 0; b < B; b++) {
        uint8_t* o = out + out_offsets[b];
        int64_t wl = w_lens[b] < W ? w_lens[b] : W;
        const int8_t* cb = col_base + b * W;
        const int8_t* cd = col_del + b * W;
        const uint8_t* il = ins_len + b * W;
        const int32_t* ip = ins_pack + b * W;
        // prefix: offsets count outward from column 0 -> reversed
        int32_t pl = pre_len[b];
        uint32_t pp = (uint32_t)pre_pack[b];
        for (int32_t t = pl - 1; t >= 0; t--)
            *o++ = (pp >> (2 * t)) & 3;
        for (int64_t j = 0; j < wl; j++) {
            if (!cd[j]) *o++ = (uint8_t)cb[j];
            uint32_t pk = (uint32_t)ip[j];
            for (int32_t t = 0; t < (int32_t)il[j]; t++)
                *o++ = (pk >> (2 * t)) & 3;
        }
        int32_t sl = suf_len[b];
        uint32_t sp = (uint32_t)suf_pack[b];
        for (int32_t t = 0; t < sl; t++)
            *o++ = (sp >> (2 * t)) & 3;
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched posterior-span local alignment (host fast path for the
// stitcher at small lane counts).
//
// Bit-equal to the device aligner's span contract — the union bounding
// box of matched cells over ALL optimal local alignments
// (ops/align.py posterior_summary + summary_spans at max_hgap=0,
// band=0, the stitch scoring): cell (i, j) is matched iff
// fwd_match(i, j) + bwd_cont(i+1, j+1) == opt.  The reference reads
// the same span fields off SSW (correctionAlignment.cpp:91-93); tie
// behavior there is unspecified, ours is the deterministic union box
// on every backend.
//
// Per-row int16 state mirrors the XLA recurrence exactly (values
// never leave int16 range by construction, so int32 intermediates for
// the gap scans are value-equal).

extern "C" {

static void posterior_spans_one(
    const uint8_t* q, int lq, const uint8_t* r, int lr,
    int match, int mismatch, int open_, int ext,
    int16_t* hm_all,                       // [lq * lr] scratch
    int16_t* row6,                         // [6 * lr] scratch
    int32_t* out5) {
    const int16_t NEGV = -16384;           // ops/align.py NEG
    if (lq == 0 || lr == 0) {
        out5[0] = 0; out5[1] = -1; out5[2] = 0; out5[3] = -1;
        out5[4] = 0;
        return;
    }
    int16_t* h_prev = row6;
    int16_t* h_cur = row6 + lr;
    int16_t* f_prev = row6 + 2 * lr;
    int16_t* f_cur = row6 + 3 * lr;
    for (int j = 0; j < lr; j++) { h_prev[j] = 0; f_prev[j] = NEGV; }
    const int16_t m16 = (int16_t)match, x16 = (int16_t)mismatch;
    int32_t opt = 0;
    for (int i = 0; i < lq; i++) {
        int16_t* __restrict__ hm = hm_all + (int64_t)i * lr;
        int16_t* __restrict__ hp = h_prev;
        int16_t* __restrict__ fp = f_prev;
        int16_t* __restrict__ hc = h_cur;
        int16_t* __restrict__ fc = f_cur;
        const uint8_t qc = q[i];
        // hm[j] = H[i-1][j-1] + sub(i, j); f/ht vector-friendly
        hm[0] = (qc == r[0]) ? m16 : x16;
        for (int j = 1; j < lr; j++)
            hm[j] = (int16_t)(hp[j - 1] + ((qc == r[j]) ? m16 : x16));
        int16_t row_max = NEGV;
        for (int j = 0; j < lr; j++) {
            int16_t fv = std::max<int16_t>(
                (int16_t)(hp[j] - open_), (int16_t)(fp[j] - ext));
            fc[j] = fv;
            hc[j] = std::max<int16_t>(std::max<int16_t>(hm[j], fv), 0);
            row_max = std::max(row_max, hm[j]);
        }
        if (row_max > opt) opt = row_max;
        // E(j) = max_{k<j}(ht(k) - (j-1-k)*ext) - open, via the decayed
        // running max dm(j+1) = max(ht(j), dm(j) - ext).  Value-equal
        // to the XLA prefix-max form: the NEG-seed branch differs by
        // ext but stays < 0 while ht >= 0 always wins the max.
        int16_t dm = NEGV;
        for (int j = 0; j < lr; j++) {
            int16_t ht = hc[j];
            int16_t e = (int16_t)(dm - open_);
            if (e > ht) hc[j] = e;
            dm = std::max<int16_t>((int16_t)(dm - ext), ht);
        }
        std::swap(h_prev, h_cur);
        std::swap(f_prev, f_cur);
    }
    if (opt <= 0) {
        out5[0] = 0; out5[1] = -1; out5[2] = 0; out5[3] = -1;
        out5[4] = 0;
        return;
    }
    // backward + streaming box reduction
    int16_t* bh_prev = row6;               // row i+1
    int16_t* bh_cur = row6 + lr;
    int16_t* bf_prev = row6 + 2 * lr;
    int16_t* bf_cur = row6 + 3 * lr;
    int16_t* bt = row6 + 4 * lr;
    for (int j = 0; j < lr; j++) { bh_prev[j] = 0; bf_prev[j] = NEGV; }
    const int16_t opt16 = (int16_t)opt;
    int qb = lq, qe = -1, rb = lr, re = -1;
    const int16_t ma16 = (int16_t)match, mi16 = (int16_t)mismatch;
    for (int i = lq - 1; i >= 0; i--) {
        const int16_t* __restrict__ hm = hm_all + (int64_t)i * lr;
        int16_t* __restrict__ bhp = bh_prev;
        int16_t* __restrict__ bfp = bf_prev;
        int16_t* __restrict__ bhc = bh_cur;
        int16_t* __restrict__ bfc = bf_cur;
        int16_t* __restrict__ btr = bt;
        const uint8_t qc = q[i];
        int any = 0;
        for (int j = 0; j < lr - 1; j++)
            any |= (hm[j] > NEGV / 2) &&
                   ((int16_t)(hm[j] + bhp[j + 1]) == opt16);
        any |= (hm[lr - 1] > NEGV / 2) && (hm[lr - 1] == opt16);
        if (any) {
            for (int j = 0; j < lr; j++) {
                int16_t bhd = (j + 1 < lr) ? bhp[j + 1] : (int16_t)0;
                if (hm[j] > NEGV / 2 &&
                    (int16_t)(hm[j] + bhd) == opt16) {
                    if (i < qb) qb = i;
                    if (i > qe) qe = i;
                    if (j < rb) rb = j;
                    if (j > re) re = j;
                }
            }
        }
        for (int j = 0; j < lr - 1; j++) {
            int16_t bm = (int16_t)(((qc == r[j]) ? ma16 : mi16)
                                   + bhp[j + 1]);
            int16_t bfv = std::max<int16_t>(
                (int16_t)(bhp[j] - open_), (int16_t)(bfp[j] - ext));
            bfc[j] = bfv;
            btr[j] = std::max<int16_t>(std::max<int16_t>(bm, bfv), 0);
        }
        {
            int j = lr - 1;
            int16_t bm = (qc == r[j]) ? ma16 : mi16;
            int16_t bfv = std::max<int16_t>(
                (int16_t)(bhp[j] - open_), (int16_t)(bfp[j] - ext));
            bfc[j] = bfv;
            btr[j] = std::max<int16_t>(std::max<int16_t>(bm, bfv), 0);
        }
        // bE(j) = max_{k>j}(bt(k) - (k-1-j)*ext) - open (decayed
        // suffix max; NEG-seed discrepancy vs the XLA form is < 0 and
        // never beats bt >= 0, as in the forward scan)
        int16_t dm = NEGV;
        for (int j = lr - 1; j >= 0; j--) {
            int16_t btv = btr[j];
            int16_t be = (int16_t)(dm - open_);
            bhc[j] = be > btv ? be : btv;
            dm = std::max<int16_t>((int16_t)(dm - ext), btv);
        }
        std::swap(bh_prev, bh_cur);
        std::swap(bf_prev, bf_cur);
    }
    if (qe < 0) {
        out5[0] = 0; out5[1] = -1; out5[2] = 0; out5[3] = -1;
        out5[4] = 0;
    } else {
        out5[0] = qb; out5[1] = qe; out5[2] = rb; out5[3] = re;
        out5[4] = 1;
    }
}

void posterior_spans_batch(
    const uint8_t* qbuf, const int64_t* q_off, const int64_t* q_len,
    const uint8_t* rbuf, const int64_t* r_off, const int64_t* r_len,
    int64_t n_pairs, int match, int mismatch, int gap_open,
    int gap_ext, int32_t* out /* n_pairs x 5 */) {
    int max_lq = 0, max_lr = 0;
    for (int64_t p = 0; p < n_pairs; p++) {
        if (q_len[p] > max_lq) max_lq = (int)q_len[p];
        if (r_len[p] > max_lr) max_lr = (int)r_len[p];
    }
    std::vector<int16_t> hm((int64_t)max_lq * max_lr);
    std::vector<int16_t> rows((int64_t)6 * std::max(max_lr, 1));
    for (int64_t p = 0; p < n_pairs; p++) {
        posterior_spans_one(
            qbuf + q_off[p], (int)q_len[p], rbuf + r_off[p],
            (int)r_len[p], match, mismatch, gap_open, gap_ext,
            hm.data(), rows.data(), out + 5 * p);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-round batched stitch apply: one ctypes call applies EVERY live
// job's window splice (stitch_apply_step per job, parameters unpacked
// from pointer/scalar arrays).  The per-window Python/ctypes glue
// around stitch_apply_step (~15 argument conversions per call) was the
// stitch.apply stage's dominant cost (VERDICT r4 #6); here the glue is
// paid once per round and the loop runs GIL-free.
//
// scal: [n, 15] row-major int64 per job:
//   0 cur_len  1 cons_n  2 raw_cons_len  3 q_begin  4 q_end
//   5 r_begin  6 r_end   7 al_pos        8 i_window 9 old_end
//   10 has_old 11 old_len 12 n_old       13 n_cur   14 track_old
// Arena offsets give each job's private output capacity; meta[j*5..]
// is stitch_apply_step's out_meta (meta[j*5] == -1 on capacity
// overflow for that job only).

extern "C" void stitch_apply_round(
    int64_t n,
    const uint8_t* const* out_c_ptrs, const uint8_t* const* out_s_ptrs,
    const uint8_t* const* cons_c_ptrs,
    const uint8_t* const* cons_s_ptrs,
    const uint8_t* const* old_c_ptrs, const uint8_t* const* old_s_ptrs,
    const int64_t* const* old_keys_ptrs,
    const int32_t* const* old_vals_ptrs,
    const int64_t* const* cur_keys_ptrs,
    const int32_t* const* cur_vals_ptrs,
    const int64_t* scal,
    int k, int solid_thresh,
    int match, int mismatch, int gap_open, int gap_ext,
    uint8_t* out_arena, uint8_t* outs_arena,
    const int64_t* out_arena_off,
    uint8_t* cur_arena, uint8_t* curs_arena,
    const int64_t* cur_arena_off,
    int64_t* meta) {
    for (int64_t j = 0; j < n; j++) {
        const int64_t* s = scal + j * 15;
        stitch_apply_step(
            out_c_ptrs[j], out_s_ptrs[j], s[0],
            cons_c_ptrs[j], cons_s_ptrs[j], s[1], s[2],
            s[3], s[4], s[5], s[6],
            s[7], s[8], s[9],
            old_c_ptrs[j], old_s_ptrs[j], s[11], s[10],
            old_keys_ptrs[j], old_vals_ptrs[j], s[12],
            cur_keys_ptrs[j], cur_vals_ptrs[j], s[13],
            k, solid_thresh, match, mismatch, gap_open, gap_ext,
            s[14],
            out_arena + out_arena_off[j], outs_arena + out_arena_off[j],
            out_arena_off[j + 1] - out_arena_off[j],
            cur_arena + cur_arena_off[j], curs_arena + cur_arena_off[j],
            cur_arena_off[j + 1] - cur_arena_off[j],
            meta + j * 5);
    }
}
