// A chunk's stitch jobs in one native table, driven in lockstep rounds
// (consent_tpu_torch/pipeline/stitch_rounds.py).
//
// The table holds every job's inputs (raw read, each window's query --
// its consensus, or its template when the consensus is shorter than k --
// with its solid mask, the raw consensus length, the window's start and
// its k-mer counts) and each job's evolving state (pipeline/stitch.py
// StitchJob: out_c / out_s, cur_pos, old_end, the previous splice, the
// previous window's counts, the window index).  A round is two calls:
//
//   sr_requests  the live jobs' (query, slab) pairs, as
//                StitchJob.next_request picks them, into compact blobs;
//   sr_apply     the collected [n, 5] spans, each through host.cpp's
//                stitch_apply_step, the jobs' state advanced.
//
// Compiled into the same library as host.cpp (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

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
    int64_t* out_meta);

namespace {

struct Job {
    int64_t w0 = 0, nw = 0;     // windows w0 .. w0 + nw - 1 of the table
    int64_t i = 0;              // next window, 0 .. nw
    int64_t cur_pos = 0;
    int64_t old_end = 0;
    int64_t old_win = -1;       // table window of old_mers; -1: no old_cons
    int64_t al_pos = 0;         // of the request given last
    std::vector<uint8_t> out_c, out_s, old_c, old_s;
};

struct Table {
    int k, thresh, match, mismatch, gap_open, gap_ext;
    int64_t size_al, overlap;
    std::vector<const uint8_t*> q, s;   // each window's query, solid
    std::vector<int64_t> q_len, raw_cons_len, pos0, n_keys;
    std::vector<const int64_t*> keys;
    std::vector<const int32_t*> vals;
    std::vector<Job> jobs;
    // stitch_apply_step's outputs, reused across jobs and rounds
    std::vector<uint8_t> new_c, new_s, cur_c, cur_s;
};

// StitchJob.next_request's slab: [al_pos, al_pos + len) of out_c
int64_t slab_len(const Table& t, Job& job) {
    job.al_pos = std::max<int64_t>(0, job.cur_pos - t.overlap);
    const int64_t n = (int64_t)job.out_c.size();
    return std::max<int64_t>(0, std::min(t.size_al, n - job.al_pos));
}

// StitchJob.apply of job's current window by span sp (q_begin, q_end,
// r_begin, r_end, valid); false, the job left as it was, when a splice
// outgrows its capacity.  The splice `cur` is at most the query's span
// plus the previous splice's overlap it keeps (<= qn + old_len), and the
// read grows by at most |cur|, so the capacities cannot be short for a
// span inside its query and slab.
bool apply_window(Table& t, Job& job, const int32_t* sp) {
    if (!sp[4]) {                   // no alignment: skip the window
        job.i++;
        return true;
    }
    const int64_t w = job.w0 + job.i;
    const int64_t qn = t.q_len[w];
    const bool use_old = job.i != 0 && job.old_win >= 0;
    const int64_t old_len = use_old ? (int64_t)job.old_c.size() : 0;
    const int64_t cur_len = (int64_t)job.out_c.size();
    const int64_t cur_cap = qn + old_len;
    const int64_t out_cap = cur_len + cur_cap;
    t.new_c.resize(std::max<int64_t>(out_cap, 1));
    t.new_s.resize(std::max<int64_t>(out_cap, 1));
    t.cur_c.resize(std::max<int64_t>(cur_cap, 1));
    t.cur_s.resize(std::max<int64_t>(cur_cap, 1));
    int64_t meta[5];
    stitch_apply_step(
        job.out_c.data(), job.out_s.data(), cur_len, t.q[w], t.s[w], qn,
        t.raw_cons_len[w], sp[0], sp[1], sp[2], sp[3], job.al_pos, job.i,
        use_old ? job.old_end : -(int64_t(1) << 40),
        use_old ? job.old_c.data() : nullptr,
        use_old ? job.old_s.data() : nullptr, old_len, use_old ? 1 : 0,
        use_old ? t.keys[job.old_win] : nullptr,
        use_old ? t.vals[job.old_win] : nullptr,
        use_old ? t.n_keys[job.old_win] : 0,
        t.keys[w], t.vals[w], t.n_keys[w],
        t.k, t.thresh, t.match, t.mismatch, t.gap_open, t.gap_ext,
        job.i < job.nw - 1 ? 1 : 0,
        t.new_c.data(), t.new_s.data(), out_cap,
        t.cur_c.data(), t.cur_s.data(), cur_cap, meta);
    if (meta[0] < 0) return false;
    const int64_t spliced = meta[1];
    if (meta[4]) {                  // the read was spliced
        job.out_c.swap(t.new_c);
        job.out_s.swap(t.new_s);
        job.out_c.resize(meta[0]);
        job.out_s.resize(meta[0]);
    }
    if (spliced && meta[3]) {       // the splice is tracked
        job.cur_pos += t.pos0[w + 1] - t.pos0[w] - (sp[3] - sp[2] + 1)
                       + spliced;
        job.old_c.assign(t.cur_c.begin(), t.cur_c.begin() + spliced);
        job.old_s.assign(t.cur_s.begin(), t.cur_s.begin() + spliced);
        job.old_win = w;
        job.old_end = meta[2];
    }
    job.i++;
    return true;
}

}  // namespace

extern "C" {

// Each window's query and solid mask (uint8, q_len bytes), sorted k-mers
// (int64) and their counts (int32, n_keys each) are numpy arrays, given
// as the addresses of their array objects, whose data pointer lies
// data_offset bytes in (read here once); the caller keeps them alive as
// long as the table.
void* sr_new(int64_t n_jobs, const int64_t* job_win_off,
             const uint8_t* raw_blob, const int64_t* raw_off,
             const uint64_t* q_objs, const uint64_t* s_objs,
             const int64_t* q_len, const int64_t* raw_cons_len,
             const int64_t* pos0, const uint64_t* key_objs,
             const uint64_t* val_objs, const int64_t* n_keys,
             int64_t data_offset,
             int k, int solid_thresh, int match, int mismatch,
             int gap_open, int gap_ext, int64_t window_size,
             int64_t window_overlap) {
    Table* t = new Table();
    t->k = k;
    t->thresh = solid_thresh;
    t->match = match;
    t->mismatch = mismatch;
    t->gap_open = gap_open;
    t->gap_ext = gap_ext;
    t->size_al = window_size + 2 * window_overlap;
    t->overlap = window_overlap;
    const int64_t n_win = job_win_off[n_jobs];
    auto data = [data_offset](uint64_t obj) {
        return *reinterpret_cast<void* const*>(obj + data_offset);
    };
    t->q.resize(n_win);
    t->s.resize(n_win);
    t->keys.resize(n_win);
    t->vals.resize(n_win);
    for (int64_t w = 0; w < n_win; w++) {
        t->q[w] = static_cast<const uint8_t*>(data(q_objs[w]));
        t->s[w] = static_cast<const uint8_t*>(data(s_objs[w]));
        t->keys[w] = static_cast<const int64_t*>(data(key_objs[w]));
        t->vals[w] = static_cast<const int32_t*>(data(val_objs[w]));
    }
    t->q_len.assign(q_len, q_len + n_win);
    t->raw_cons_len.assign(raw_cons_len, raw_cons_len + n_win);
    t->pos0.assign(pos0, pos0 + n_win);
    t->n_keys.assign(n_keys, n_keys + n_win);
    t->jobs.resize(n_jobs);
    for (int64_t j = 0; j < n_jobs; j++) {
        Job& job = t->jobs[j];
        job.w0 = job_win_off[j];
        job.nw = job_win_off[j + 1] - job_win_off[j];
        job.out_c.assign(raw_blob + raw_off[j], raw_blob + raw_off[j + 1]);
        job.out_s.assign(job.out_c.size(), 0);
        job.cur_pos = job.nw ? pos0[job.w0] : 0;
    }
    return t;
}

void sr_free(void* table) { delete static_cast<Table*>(table); }

// The requests of jobs ids[0..n): queries into q_rows at q_off / q_len,
// slabs into r_rows at r_off / r_len (compact, in lane order).  Returns
// 0, or -1 when a capacity is short.
int64_t sr_requests(void* table, const int64_t* ids, int64_t n,
                    uint8_t* q_rows, int64_t q_cap, int64_t* q_off_out,
                    int64_t* q_len_out, uint8_t* r_rows, int64_t r_cap,
                    int64_t* r_off_out, int64_t* r_len_out) {
    Table& t = *static_cast<Table*>(table);
    int64_t qo = 0, ro = 0;
    for (int64_t l = 0; l < n; l++) {
        Job& job = t.jobs[ids[l]];
        const int64_t w = job.w0 + job.i;
        const int64_t ql = t.q_len[w];
        const int64_t rl = slab_len(t, job);
        if (qo + ql > q_cap || ro + rl > r_cap) return -1;
        if (ql) std::memcpy(q_rows + qo, t.q[w], ql);
        if (rl) std::memcpy(r_rows + ro, job.out_c.data() + job.al_pos, rl);
        q_off_out[l] = qo;
        q_len_out[l] = ql;
        r_off_out[l] = ro;
        r_len_out[l] = rl;
        qo += ql;
        ro += rl;
    }
    return 0;
}

// Apply the spans [n, 5] of the round sr_requests gave last for
// ids[0..n), each job's window by apply_window, and compact ids in place
// to the jobs with windows left, in order.  Returns their count, or -1
// when a splice outgrew its capacity (a span outside its pair).
int64_t sr_apply(void* table, int64_t* ids, int64_t n,
                 const int32_t* spans) {
    Table& t = *static_cast<Table*>(table);
    int64_t live = 0;
    for (int64_t l = 0; l < n; l++)
        if (!apply_window(t, t.jobs[ids[l]], spans + 5 * l)) return -1;
    for (int64_t l = 0; l < n; l++) {
        const Job& job = t.jobs[ids[l]];
        if (job.i < job.nw) ids[live++] = ids[l];
    }
    return live;
}

// Every job's output length into lens[0..n_jobs); with non-null codes,
// the outputs too, job j's at off[j] of codes and solid.
void sr_results(void* table, int64_t* lens, const int64_t* off,
                uint8_t* codes, uint8_t* solid) {
    const Table& t = *static_cast<Table*>(table);
    for (size_t j = 0; j < t.jobs.size(); j++) {
        const Job& job = t.jobs[j];
        lens[j] = (int64_t)job.out_c.size();
        if (codes) {
            std::memcpy(codes + off[j], job.out_c.data(), job.out_c.size());
            std::memcpy(solid + off[j], job.out_s.data(), job.out_s.size());
        }
    }
}

}  // extern "C"
