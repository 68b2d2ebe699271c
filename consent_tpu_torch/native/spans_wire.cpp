// The stitch aligner's wire rows (pipeline/device_align.py
// _spans_wire_body): each lane's query and ref packed 2 bits a base,
// then their int32 lengths, in one row of Lq / 4 + Lr / 4 + 8 bytes.
//
// Compiled into the same library as host.cpp (native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

// pack_bases_host: 4 bases a byte, LSB first, zero padded to nbytes
void pack_row(const uint8_t* src, int64_t n, uint8_t* dst, int64_t nbytes) {
    std::memset(dst, 0, nbytes);
    for (int64_t p = 0; p < n; p++)
        dst[p >> 2] |= (uint8_t)(src[p] << (2 * (p & 3)));
}

}  // namespace

extern "C" {

// Lane l < n holds query q_rows[q_off[l] .. + q_len[l]) and ref
// r_rows[r_off[l] .. + r_len[l]), each at most Lq / Lr bases (multiples
// of 4); rows n .. lanes - 1 are zero.  wire: [lanes, Lq / 4 + Lr / 4 + 8].
void spans_wire_pack(const uint8_t* q_rows, const int64_t* q_off,
                     const int64_t* q_len, const uint8_t* r_rows,
                     const int64_t* r_off, const int64_t* r_len, int64_t n,
                     int64_t lanes, int64_t Lq, int64_t Lr, uint8_t* wire) {
    const int64_t row = Lq / 4 + Lr / 4 + 8;
    for (int64_t l = 0; l < n; l++) {
        uint8_t* dst = wire + l * row;
        pack_row(q_rows + q_off[l], q_len[l], dst, Lq / 4);
        pack_row(r_rows + r_off[l], r_len[l], dst + Lq / 4, Lr / 4);
        const int32_t lens[2] = {(int32_t)q_len[l], (int32_t)r_len[l]};
        std::memcpy(dst + Lq / 4 + Lr / 4, lens, 8);
    }
    std::memset(wire + n * row, 0, (lanes - n) * row);
}

}  // extern "C"
