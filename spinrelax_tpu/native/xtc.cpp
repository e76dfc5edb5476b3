// Native XTC (GROMACS compressed trajectory) codec.
//
// Implements the 3dfcoord integer compression scheme of the xdrfile
// format specification (magic 1995): coordinates are quantised by a
// precision factor, stored as big-endian XDR with absolute triples packed
// by a mixed-radix big-number code and runs of small deltas with an
// adaptive word size.  Decoder follows the published control flow
// (including the water-molecule first/second atom interchange inside
// runs); the encoder emits a valid stream exercising both absolute and
// run paths.
//
// Exposed through the plain C ABI (ctypes), like fastio.cpp.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int MAGIC = 1995;
const int FIRSTIDX = 9;

// The exact published xdrfile table, historical quirks included (5060
// rather than the mathematical 5160, 524287 = 2^19-1, 8388607 = 2^23-1):
// every conforming implementation must carry these verbatim or its
// small-run word sizes disagree with files in the wild.
const int magicints[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216};
const int LASTIDX = (int)(sizeof(magicints) / sizeof(int)) - 1;

// ---------------------------------------------------------------- XDR IO

struct Reader {
    FILE* fp;
    bool ok = true;

    uint32_t u32() {
        unsigned char b[4];
        if (fread(b, 1, 4, fp) != 4) { ok = false; return 0; }
        return ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
               ((uint32_t)b[2] << 8) | (uint32_t)b[3];
    }
    int32_t i32() { return (int32_t)u32(); }
    float f32() {
        uint32_t u = u32();
        float f;
        memcpy(&f, &u, 4);
        return f;
    }
    bool bytes(unsigned char* dst, size_t n) {
        if (fread(dst, 1, n, fp) != n) { ok = false; return false; }
        return true;
    }
    // Skip n payload bytes without reading them (header-only scans).
    // fseek happily lands past EOF, so verify against the file size —
    // a truncated final payload must still scan as corrupt.
    long fsize = -1;
    bool skip(long n) {
        long pos = ftell(fp);
        if (pos < 0) { ok = false; return false; }
        if (fsize < 0) {
            if (fseek(fp, 0, SEEK_END) != 0) { ok = false; return false; }
            fsize = ftell(fp);
            if (fsize < 0 || fseek(fp, pos, SEEK_SET) != 0) {
                ok = false;
                return false;
            }
        }
        if (pos + n > fsize || fseek(fp, n, SEEK_CUR) != 0) {
            ok = false;
            return false;
        }
        return true;
    }
    bool eof() {
        int c = fgetc(fp);
        if (c == EOF) return true;
        ungetc(c, fp);
        return false;
    }
};

struct Writer {
    FILE* fp;
    bool ok = true;  // sticky: any failed fwrite (e.g. ENOSPC) latches

    void u32(uint32_t v) {
        unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                              (unsigned char)(v >> 8), (unsigned char)v};
        if (fwrite(b, 1, 4, fp) != 4) ok = false;
    }
    void i32(int32_t v) { u32((uint32_t)v); }
    void f32(float f) {
        uint32_t u;
        memcpy(&u, &f, 4);
        u32(u);
    }
    void bytes(const unsigned char* src, size_t n) {
        if (fwrite(src, 1, n, fp) != n) ok = false;
    }
};

// ------------------------------------------------------------- bit codec

struct BitBuf {
    std::vector<unsigned char> data;
    size_t cnt = 0;           // byte cursor
    int lastbits = 0;         // encoder: bits held in lastbyte
    uint32_t lastbyte = 0;
    uint64_t cache = 0;       // decoder: pending bits, LSB-justified
    int nbits = 0;            // decoder: bits held in cache
    bool overrun = false;     // decode read past the frame payload

    unsigned char next() {
        if (cnt >= data.size()) {
            overrun = true;
            return 0;
        }
        return data[cnt++];
    }
};

static void encodebits(BitBuf& buf, int num_of_bits, uint32_t num) {
    uint32_t lastbyte = buf.lastbyte;
    int lastbits = buf.lastbits;
    while (num_of_bits >= 8) {
        lastbyte = (lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xff);
        buf.data.push_back((unsigned char)(lastbyte >> lastbits));
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) {
        lastbyte = (lastbyte << num_of_bits) | (num & ((1u << num_of_bits) - 1));
        lastbits += num_of_bits;
        if (lastbits >= 8) {
            lastbits -= 8;
            buf.data.push_back((unsigned char)(lastbyte >> lastbits));
        }
    }
    buf.lastbits = lastbits;
    buf.lastbyte = lastbyte;
}

static void flushbits(BitBuf& buf) {
    if (buf.lastbits > 0) {
        buf.data.push_back((unsigned char)(buf.lastbyte << (8 - buf.lastbits)));
        buf.lastbits = 0;
        buf.lastbyte = 0;
    }
}

static uint32_t decodebits(BitBuf& buf, int num_of_bits) {
    // MSB-first bit reader with a 64-bit cache and bulk 32-bit refills —
    // bit-exact with the canonical byte-at-a-time loop (the cache only
    // changes WHEN bytes are fetched, never which bits are consumed;
    // consuming past the padded payload still trips `overrun` via
    // next()).  Pinned by the differential fuzz suite.
    while (buf.nbits < num_of_bits) {
        if (buf.nbits <= 32 && buf.cnt + 4 <= buf.data.size()) {
            const unsigned char* p = &buf.data[buf.cnt];
            buf.cache = (buf.cache << 32) |
                        ((uint64_t)p[0] << 24) | ((uint64_t)p[1] << 16) |
                        ((uint64_t)p[2] << 8) | (uint64_t)p[3];
            buf.cnt += 4;
            buf.nbits += 32;
        } else {
            buf.cache = (buf.cache << 8) | buf.next();
            buf.nbits += 8;
        }
    }
    buf.nbits -= num_of_bits;
    uint32_t mask = num_of_bits == 32 ? 0xffffffffu : (1u << num_of_bits) - 1;
    return (uint32_t)(buf.cache >> buf.nbits) & mask;
}

static int sizeofint(uint32_t size) {
    uint32_t num = 1;
    int num_of_bits = 0;
    while (size >= num && num_of_bits < 32) {
        num_of_bits++;
        num <<= 1;
    }
    return num_of_bits;
}

static int sizeofints(int num_of_ints, const uint32_t sizes[]) {
    uint32_t bytes[32];
    uint32_t num_of_bytes = 1;
    bytes[0] = 1;
    int num_of_bits = 0;
    for (int i = 0; i < num_of_ints; i++) {
        uint32_t tmp = 0;
        uint32_t bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    uint32_t num = 1;
    num_of_bytes--;
    while (bytes[num_of_bytes] >= num) {
        num_of_bits++;
        num *= 2;
    }
    return num_of_bits + (int)num_of_bytes * 8;
}

static void encodeints(BitBuf& buf, int num_of_ints, int num_of_bits,
                       const uint32_t sizes[], const uint32_t nums[]) {
    uint32_t bytes[32];
    int num_of_bytes = 0;
    uint32_t tmp = nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < num_of_ints; i++) {
        // bignum = bignum * sizes[i] + nums[i]
        tmp = nums[i];
        int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
        for (int i = 0; i < num_of_bytes; i++) encodebits(buf, 8, bytes[i]);
        encodebits(buf, num_of_bits - num_of_bytes * 8, 0);
    } else {
        int i;
        for (i = 0; i < num_of_bytes - 1; i++) encodebits(buf, 8, bytes[i]);
        encodebits(buf, num_of_bits - (num_of_bytes - 1) * 8, bytes[i]);
    }
}

// Exact u64-by-u32 division via a 2^63-scaled reciprocal + one fixup:
// for v < 2^56 (the decodeints fast-path bound) and any d >= 1,
// q' = (v * floor(2^63/d)) >> 63 is floor(v/d) or one less (the deficit
// v*e/(d*2^63) with e = 2^63 mod d is < v/2^63 < 1), so a single
// conditional correction makes it exact — a multiply+shift instead of
// a ~25-cycle hardware divide in the per-atom decode loop.
struct Div {
    uint64_t rinv = 0;
    uint32_t d = 0;
    void set(uint32_t dd) {
        d = dd;
        rinv = (uint64_t)(((unsigned __int128)1 << 63) / dd);
    }
    inline uint64_t divmod(uint64_t v, uint32_t& rem) const {
        uint64_t q = (uint64_t)(((unsigned __int128)v * rinv) >> 63);
        uint64_t r = v - q * d;
        if (r >= d) { q++; r -= d; }
        rem = (uint32_t)r;
        return q;
    }
};

static void decodeints(BitBuf& buf, int num_of_ints, int num_of_bits,
                       const uint32_t sizes[], const Div divs[],
                       int32_t nums[]) {
    // Fast path: the packed big number fits in 56 bits (every physical
    // frame: a 3-int pack needs > 56 bits only for > ~2^18 units/dim,
    // and the > 2^24-per-dim case bypasses decodeints entirely).  The
    // mixed-radix decode then needs num_of_ints-1 reciprocal divisions
    // total, instead of one u32 hardware division PER BYTE per int in
    // the canonical byte-wise bignum loop — the decoder's dominant
    // cost.  Bit-exact with the reference loop incl. the low-32-bit
    // truncation of nums[0] (pinned by the differential fuzz suite,
    // test_xtc_fuzz).
    if (num_of_bits <= 56) {
        // The pack is a little-endian byte sequence of MSB-first 8-bit
        // groups plus one 1..8-bit tail group; reading several groups
        // at once yields (b_k<<..)|..|b_{k+m} — a bswap restores the LE
        // value.  Identical bits consumed in identical order to the
        // canonical per-byte loop, in <= 4 reader calls instead of 8.
        int full = (num_of_bits - 1) / 8;      // full 8-bit groups
        int tail = num_of_bits - 8 * full;     // 1..8 bits
        uint64_t v = 0;
        int shift = 0;
        if (full >= 4) {
            v = (uint64_t)__builtin_bswap32(decodebits(buf, 32));
            shift = 32;
            full -= 4;
        }
        if (full >= 2) {
            v |= (uint64_t)__builtin_bswap16((uint16_t)decodebits(buf, 16))
                 << shift;
            shift += 16;
            full -= 2;
        }
        if (full >= 1) {
            v |= (uint64_t)decodebits(buf, 8) << shift;
            shift += 8;
        }
        v |= (uint64_t)decodebits(buf, tail) << shift;
        for (int i = num_of_ints - 1; i > 0; i--) {
            uint32_t rem;
            v = divs[i].divmod(v, rem);
            nums[i] = (int32_t)rem;
        }
        nums[0] = (int32_t)(uint32_t)v;
        return;
    }
    uint32_t bytes[32] = {0, 0, 0, 0};
    int num_of_bytes = 0;
    while (num_of_bits > 8) {
        bytes[num_of_bytes++] = decodebits(buf, 8);
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = decodebits(buf, num_of_bits);
    for (int i = num_of_ints - 1; i > 0; i--) {
        uint32_t num = 0;
        for (int j = num_of_bytes - 1; j >= 0; j--) {
            num = (num << 8) | bytes[j];
            uint32_t p = num / sizes[i];
            bytes[j] = p;
            num = num - p * sizes[i];
        }
        nums[i] = (int32_t)num;
    }
    nums[0] = (int32_t)(bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                        (bytes[3] << 24));
}

// ------------------------------------------------------- frame handling

struct FrameHeader {
    int natoms = 0;
    int step = 0;
    float time = 0.0f;
    float box[9];
};

static bool read_frame(Reader& rd, FrameHeader& h, float* xyz /*natoms*3 or null*/,
                       int expected_natoms = -1) {
    int magic = rd.i32();
    if (!rd.ok) return false;
    if (magic != MAGIC) return false;
    h.natoms = rd.i32();
    h.step = rd.i32();
    h.time = rd.f32();
    for (int i = 0; i < 9; i++) h.box[i] = rd.f32();
    int lsize = rd.i32();
    if (lsize != h.natoms) return false;
    // The caller's xyz buffer is sized for expected_natoms: refuse BEFORE
    // any decompression writes (a mid-stream frame with a larger natoms
    // would otherwise overrun the buffer).
    if (xyz && expected_natoms >= 0 && h.natoms != expected_natoms)
        return false;
    if (h.natoms <= 9) {
        for (int i = 0; i < h.natoms * 3; i++) {
            float v = rd.f32();
            if (xyz) xyz[i] = v;
        }
        return rd.ok;
    }
    float precision = rd.f32();
    int32_t minint[3], maxint[3];
    for (int i = 0; i < 3; i++) minint[i] = rd.i32();
    for (int i = 0; i < 3; i++) maxint[i] = rd.i32();
    int smallidx = rd.i32();
    int nbytes = rd.i32();
    if (!rd.ok || nbytes < 0) return false;
    // Foreign-bytes safety: smallidx indexes magicints and sets the
    // decodeints bit width — out-of-range values would drive OOB reads
    // and a stack overflow in the decode scratch.
    const int n_magic = (int)(sizeof(magicints) / sizeof(magicints[0]));
    if (smallidx < FIRSTIDX || smallidx >= n_magic - 1) return false;

    size_t padded = (size_t)((nbytes + 3) / 4) * 4;
    if (!xyz) return rd.skip((long)padded);  // header-only scan: no read
    BitBuf buf;
    buf.data.resize(padded);
    if (!rd.bytes(buf.data.data(), buf.data.size())) return false;

    uint32_t sizeint[3], sizesmall[3], bitsizeint[3] = {0, 0, 0};
    for (int i = 0; i < 3; i++) {
        sizeint[i] = (uint32_t)(maxint[i] - minint[i] + 1);
        // Hostile maxint < minint wraps to 0 and would reach a division
        // by zero in the mixed-radix decode (SIGFPE); legit frames
        // always have sizeint >= 1.
        if (sizeint[i] == 0) return false;
    }
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        for (int i = 0; i < 3; i++) bitsizeint[i] = sizeofint(sizeint[i]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }
    int tmpidx = smallidx - 1;
    tmpidx = (FIRSTIDX > tmpidx) ? FIRSTIDX : tmpidx;
    int smaller = magicints[tmpidx] / 2;
    int small = magicints[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];

    // Reciprocal dividers for the decodeints fast path (only indices
    // 1..2 are divided by).  divint is per-frame constant; divsmall
    // follows smallidx and is refreshed only when it changes.
    Div divint[3], divsmall[3];
    divint[1].set(sizeint[1]);
    divint[2].set(sizeint[2]);
    divsmall[1].set(sizesmall[1]);
    divsmall[2] = divsmall[1];

    float inv_precision = 1.0f / precision;
    int32_t prevcoord[3] = {0, 0, 0};
    int run = 0;
    int i = 0;
    float* lfp = xyz;
    while (i < h.natoms) {
        int32_t thiscoord[3];
        if (bitsize == 0) {
            thiscoord[0] = (int32_t)decodebits(buf, bitsizeint[0]);
            thiscoord[1] = (int32_t)decodebits(buf, bitsizeint[1]);
            thiscoord[2] = (int32_t)decodebits(buf, bitsizeint[2]);
        } else {
            decodeints(buf, 3, bitsize, sizeint, divint, thiscoord);
        }
        i++;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        int flag = (int)decodebits(buf, 1);
        int is_smaller = 0;
        if (flag == 1) {
            run = (int)decodebits(buf, 5);
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        // Canonical 3dfcoord semantics: flag == 0 means the run length
        // did NOT change — the previous `run` persists (GROMACS'
        // encoder only re-signals on change).  Resetting to 0 here
        // desynced the bitstream against real GROMACS files.
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                if (i >= h.natoms) return false;  // corrupt run overruns buffer
                decodeints(buf, 3, smallidx, sizesmall, divsmall, thiscoord);
                i++;
                thiscoord[0] += prevcoord[0] - small;
                thiscoord[1] += prevcoord[1] - small;
                thiscoord[2] += prevcoord[2] - small;
                if (k == 0) {
                    // Interchange first with second atom (water heuristic).
                    int32_t t;
                    t = thiscoord[0]; thiscoord[0] = prevcoord[0]; prevcoord[0] = t;
                    t = thiscoord[1]; thiscoord[1] = prevcoord[1]; prevcoord[1] = t;
                    t = thiscoord[2]; thiscoord[2] = prevcoord[2]; prevcoord[2] = t;
                    *lfp++ = prevcoord[0] * inv_precision;
                    *lfp++ = prevcoord[1] * inv_precision;
                    *lfp++ = prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                *lfp++ = thiscoord[0] * inv_precision;
                *lfp++ = thiscoord[1] * inv_precision;
                *lfp++ = thiscoord[2] * inv_precision;
            }
        } else {
            *lfp++ = thiscoord[0] * inv_precision;
            *lfp++ = thiscoord[1] * inv_precision;
            *lfp++ = thiscoord[2] * inv_precision;
        }
        smallidx += is_smaller;
        // Foreign-bytes safety: a hostile stream can walk smallidx past
        // the magicints table one is_smaller=+1 block at a time (the
        // header check only bounds the STARTING index) — clamp before
        // any magicints[smallidx] read.  Indices in [0, FIRSTIDX) hit
        // the table's leading zeros and are rejected by the
        // sizesmall==0 check below, matching canonical xdrfile.
        if (smallidx < 0 || smallidx > LASTIDX) return false;
        if (is_smaller < 0) {
            small = smaller;
            smaller = (smallidx > FIRSTIDX) ? magicints[smallidx - 1] / 2 : 0;
        } else if (is_smaller > 0) {
            smaller = small;
            small = magicints[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)magicints[smallidx];
        if (sizesmall[0] == 0) return false;  // corrupted stream
        if (is_smaller != 0) {  // refresh the reciprocal only on change
            divsmall[1].set(sizesmall[1]);
            divsmall[2] = divsmall[1];
        }
    }
    return !buf.overrun;  // truncated payload = corrupt frame
}

static void write_frame(Writer& wr, int natoms, int step, float time,
                        const float* box9, const float* xyz, float precision) {
    wr.i32(MAGIC);
    wr.i32(natoms);
    wr.i32(step);
    wr.f32(time);
    for (int i = 0; i < 9; i++) wr.f32(box9 ? box9[i] : 0.0f);
    wr.i32(natoms);
    if (natoms <= 9) {
        for (int i = 0; i < natoms * 3; i++) wr.f32(xyz[i]);
        return;
    }
    wr.f32(precision);

    std::vector<int32_t> ip(natoms * 3);
    int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    for (int a = 0; a < natoms; a++) {
        for (int d = 0; d < 3; d++) {
            float f = xyz[a * 3 + d] * precision;
            // Quantisation overflow (stray coordinate, NaN, precision
            // too high) is int32-cast UB that would encode a silently
            // corrupt frame; xdrfile errors here ('scaling will cause
            // overflow') and so do we.
            if (!(f > -2.0e9f && f < 2.0e9f)) { wr.ok = false; return; }
            int32_t v = (int32_t)(f >= 0 ? f + 0.5f : f - 0.5f);
            ip[a * 3 + d] = v;
            if (v < minint[d]) minint[d] = v;
            if (v > maxint[d]) maxint[d] = v;
        }
    }
    for (int d = 0; d < 3; d++) wr.i32(minint[d]);
    for (int d = 0; d < 3; d++) wr.i32(maxint[d]);

    uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++) sizeint[d] = (uint32_t)(maxint[d] - minint[d] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        for (int d = 0; d < 3; d++) bitsizeint[d] = sizeofint(sizeint[d]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    // Fixed small word size (valid, non-adaptive encoder: is_smaller == 0
    // always, encoded as run = 3*n + 1).
    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX - 1 && magicints[smallidx] < 1024) smallidx++;
    int small = magicints[smallidx] / 2;
    uint32_t sizesmall[3] = {(uint32_t)magicints[smallidx],
                             (uint32_t)magicints[smallidx],
                             (uint32_t)magicints[smallidx]};
    wr.i32(smallidx);

    auto fits_small = [&](const int32_t* d) {
        for (int k = 0; k < 3; k++)
            if (d[k] + small < 0 || (uint32_t)(d[k] + small) >= sizesmall[0])
                return false;
        return true;
    };

    BitBuf buf;
    int i = 0;
    int prevrun = 0;  // decoder starts with run = 0; only CHANGES are
                      // signalled (canonical 3dfcoord: flag=0 reuses it)
    while (i < natoms) {
        // Absolute atom: the decoder's run path outputs [delta-atom,
        // absolute-atom, ...], so when we have >= 2 atoms whose first
        // delta is small we emit atom i+1 as the absolute and atom i as
        // the first run element.
        int32_t d01[3];
        bool can_run = false;
        if (i + 1 < natoms) {
            for (int k = 0; k < 3; k++)
                d01[k] = ip[i * 3 + k] - ip[(i + 1) * 3 + k];
            can_run = fits_small(d01);
        }
        if (!can_run) {
            uint32_t abs3[3];
            for (int k = 0; k < 3; k++)
                abs3[k] = (uint32_t)(ip[i * 3 + k] - minint[k]);
            if (bitsize == 0) {
                for (int k = 0; k < 3; k++) encodebits(buf, bitsizeint[k], abs3[k]);
            } else {
                encodeints(buf, 3, bitsize, sizeint, abs3);
            }
            if (prevrun != 0) {
                encodebits(buf, 1, 1);
                encodebits(buf, 5, 1);  // run = 0, is_smaller = 0
                prevrun = 0;
            } else {
                encodebits(buf, 1, 0);  // run length unchanged (still 0)
            }
            i++;
            continue;
        }
        // Build a run: decoder output order is [y0(=atom i), y1(=atom i+1,
        // absolute), y2(=atom i+2), ...]; deltas chain y0 off y1, y2 off
        // y0, then consecutive.
        int max_run_atoms = 10;  // run field = 3*n + 1 <= 31
        int n = 1;               // number of run (delta) atoms; starts with y0
        
        // Count further atoms whose chained delta stays small.
        {
            int32_t prev[3] = {ip[i * 3 + 0], ip[i * 3 + 1], ip[i * 3 + 2]};  // y0
            for (int j = i + 2; j < natoms && n < max_run_atoms; j++) {
                int32_t d[3] = {ip[j * 3 + 0] - prev[0], ip[j * 3 + 1] - prev[1],
                                ip[j * 3 + 2] - prev[2]};
                if (!fits_small(d)) break;
                n++;
                prev[0] = ip[j * 3 + 0];
                prev[1] = ip[j * 3 + 1];
                prev[2] = ip[j * 3 + 2];
            }
        }
        // Emit absolute y1 = atom i+1.
        uint32_t abs3[3];
        for (int k = 0; k < 3; k++)
            abs3[k] = (uint32_t)(ip[(i + 1) * 3 + k] - minint[k]);
        if (bitsize == 0) {
            for (int k = 0; k < 3; k++) encodebits(buf, bitsizeint[k], abs3[k]);
        } else {
            encodeints(buf, 3, bitsize, sizeint, abs3);
        }
        if (3 * n != prevrun) {
            encodebits(buf, 1, 1);
            encodebits(buf, 5, (uint32_t)(3 * n + 1));  // is_smaller = 0
            prevrun = 3 * n;
        } else {
            encodebits(buf, 1, 0);  // same run length as previous block
        }
        // First delta: y0 relative to y1.
        uint32_t enc[3];
        for (int k = 0; k < 3; k++) enc[k] = (uint32_t)(d01[k] + small);
        encodeints(buf, 3, smallidx, sizesmall, enc);
        // Remaining deltas: y_{m+1} (atom i+m+1) chains off previous run
        // element (y0 for the first, then consecutive).
        int32_t prev[3] = {ip[i * 3 + 0], ip[i * 3 + 1], ip[i * 3 + 2]};
        for (int m = 1; m < n; m++) {
            int j = i + 1 + m;  // atom index of y_{m+1}
            int32_t d[3] = {ip[j * 3 + 0] - prev[0], ip[j * 3 + 1] - prev[1],
                            ip[j * 3 + 2] - prev[2]};
            for (int k = 0; k < 3; k++) enc[k] = (uint32_t)(d[k] + small);
            encodeints(buf, 3, smallidx, sizesmall, enc);
            prev[0] = ip[j * 3 + 0];
            prev[1] = ip[j * 3 + 1];
            prev[2] = ip[j * 3 + 2];
        }
        i += n + 1;
    }
    flushbits(buf);
    wr.i32((int32_t)buf.data.size());
    size_t padded = (buf.data.size() + 3) / 4 * 4;
    buf.data.resize(padded, 0);
    wr.bytes(buf.data.data(), padded);
}

}  // namespace

extern "C" {

// Scan: number of frames + atoms of the first frame.
int xtc_info(const char* path, long* n_frames, int* natoms) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    Reader rd{fp};
    long count = 0;
    FrameHeader h{};
    while (!rd.eof()) {
        if (!read_frame(rd, h, nullptr)) {
            // Bytes remained but the frame did not parse: corrupt or
            // truncated file — report it rather than under-counting.
            fclose(fp);
            return -2;
        }
        count++;
    }
    *n_frames = count;
    *natoms = h.natoms;
    fclose(fp);
    return 0;
}

// Read up to max_frames frames into xyz (max_frames*natoms*3 floats) and
// times (max_frames).  Returns frames read or negative error
// (-3 natoms mismatch, -4 mid-file decode failure / truncation).
long xtc_read(const char* path, float* xyz, float* times, float* boxes,
              long max_frames, int natoms) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    Reader rd{fp};
    long f = 0;
    FrameHeader h{};
    while (f < max_frames && !rd.eof()) {
        // Loop entry guarantees bytes remain, so a failed frame is
        // corruption/truncation — NOT a clean EOF to silently accept.
        if (!read_frame(rd, h, xyz + (size_t)f * natoms * 3, natoms)) {
            fclose(fp);
            return h.natoms > 0 && h.natoms != natoms ? -3 : -4;
        }
        times[f] = h.time;
        if (boxes) memcpy(boxes + (size_t)f * 9, h.box, 9 * sizeof(float));
        f++;
    }
    fclose(fp);
    return f;
}

// Streaming reader: opaque handle for chunked ingest of >RAM files
// (run-all.bash:359 feeds multi-GB solute.xtc trajectories; the whole-
// file xtc_read cannot serve the 10^6-frame north-star scale).
struct XtcStream {
    FILE* fp;
    int natoms;
    std::vector<char> path;  // for per-thread reopens (xtc_next_mt)
};

// Open + peek natoms from the first frame header (magic, natoms are the
// first two big-endian i32 fields); rewinds to the start.
void* xtc_open(const char* path, int* natoms) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    Reader rd{fp};
    int magic = rd.i32();
    int na = rd.i32();
    if (!rd.ok || magic != 1995 || na <= 0) {
        fclose(fp);
        return nullptr;
    }
    fseek(fp, 0, SEEK_SET);
    *natoms = na;
    XtcStream* s = new XtcStream{fp, na, {}};
    s->path.assign(path, path + strlen(path) + 1);
    return s;
}

// Read up to max_frames frames from the current position.  Returns the
// number read (0 at EOF), negative on error (-3 natoms mismatch,
// -4 mid-file decode failure / truncation).
long xtc_next(void* handle, float* xyz, float* times, float* boxes,
              long max_frames) {
    XtcStream* s = (XtcStream*)handle;
    Reader rd{s->fp};
    long f = 0;
    FrameHeader h{};
    while (f < max_frames && !rd.eof()) {
        // natoms is validated INSIDE read_frame before any decompression
        // write (the xyz chunk is sized for s->natoms), and a failure
        // with bytes remaining is an error, not EOF.
        if (!read_frame(rd, h, xyz + (size_t)f * s->natoms * 3, s->natoms))
            return h.natoms > 0 && h.natoms != s->natoms ? -3 : -4;
        times[f] = h.time;
        if (boxes) memcpy(boxes + (size_t)f * 9, h.box, 9 * sizeof(float));
        f++;
    }
    return f;
}

// Threaded chunk reader: XTC frames are self-delimiting and decode
// independently, so after a cheap header-hop scan (fseek past payloads)
// collects the next <= max_frames frame offsets, worker threads decode
// disjoint frame blocks into disjoint slices of the caller's buffers —
// each on its own FILE* over the same path.  Semantics identical to
// calling xtc_next in a loop (same -3/-4 error codes, earliest-frame
// error wins; the stream position ends after the last decoded frame).
// On a 1-core host this degrades gracefully to the sequential path.
long xtc_next_mt(void* handle, float* xyz, float* times, float* boxes,
                 long max_frames, int n_threads) {
    XtcStream* s = (XtcStream*)handle;
    if (n_threads <= 1) return xtc_next(handle, xyz, times, boxes, max_frames);

    // Scan pass: record the byte offset of each upcoming frame.
    std::vector<long> offs;
    offs.reserve((size_t)max_frames);
    Reader rd{s->fp};
    FrameHeader h{};
    long scan_end = 0;
    {
        long pos = ftell(s->fp);
        if (pos < 0) return -4;
        while ((long)offs.size() < max_frames && !rd.eof()) {
            offs.push_back(pos);
            if (!read_frame(rd, h, nullptr)) return -4;  // corrupt scan
            pos = ftell(s->fp);
            if (pos < 0) return -4;
        }
        scan_end = pos;
    }
    long n = (long)offs.size();
    if (n == 0) return 0;

    int T = n_threads;
    if ((long)T > n) T = (int)n;
    std::vector<long> status((size_t)T, 0);  // 0 ok, else error code
    std::vector<std::thread> workers;
    const char* path = s->path.data();
    int natoms = s->natoms;
    // Workers need independent file positions, so each gets its own
    // open file description.  Reopen through the HELD fd
    // (/proc/self/fd/N re-opens the same inode with a fresh offset) so
    // an .xtc unlinked or atomically replaced after xtc_open keeps
    // decoding exactly like the sequential path, which reads through
    // the retained FILE*; fall back to the stored path off-Linux.
    char fdpath[64];
    snprintf(fdpath, sizeof fdpath, "/proc/self/fd/%d", fileno(s->fp));
    long per = (n + T - 1) / T;
    for (int t = 0; t < T; t++) {
        long b0 = (long)t * per;
        long b1 = b0 + per < n ? b0 + per : n;
        if (b0 >= b1) break;
        workers.emplace_back([=, &offs, &status]() {
            FILE* fp = fopen(fdpath, "rb");
            if (!fp) fp = fopen(path, "rb");
            if (!fp) { status[t] = -4; return; }
            Reader wrd{fp};
            FrameHeader wh{};
            for (long f = b0; f < b1; f++) {
                if (f == b0 || ftell(fp) != offs[f]) {
                    if (fseek(fp, offs[f], SEEK_SET) != 0) {
                        status[t] = -4;
                        break;
                    }
                }
                if (!read_frame(wrd, wh, xyz + (size_t)f * natoms * 3, natoms)) {
                    status[t] = wh.natoms > 0 && wh.natoms != natoms ? -3 : -4;
                    break;
                }
                times[f] = wh.time;
                if (boxes) memcpy(boxes + (size_t)f * 9, wh.box, 9 * sizeof(float));
            }
            fclose(fp);
        });
    }
    for (auto& w : workers) w.join();
    for (int t = 0; t < T; t++)
        if (status[t] != 0) return status[t];  // earliest block's error
    // Leave the shared stream positioned after the last decoded frame.
    if (fseek(s->fp, scan_end, SEEK_SET) != 0) return -4;
    return n;
}

void xtc_close(void* handle) {
    XtcStream* s = (XtcStream*)handle;
    fclose(s->fp);
    delete s;
}

// ---------------------------------------------------------------------
// Fused decode -> bond-observable reduction (the streamed C(t) ingest).
//
// stage_ct_streamed consumes a decoded chunk ONLY through
//   raw_diff[f,b,:] = frm[idx_h[b]] - frm[idx_x[b]]      (f32)
//   S[f][i][j]      = sum_a A[i][a] * frm[a][j]          (f64 accum)
// (ops/orient.bond_obs_host; A is the weighted-centred reference's
// (3, natoms) correlation matrix, translation-invariant by
// construction).  Decoding into a full (frames, natoms, 3) numpy chunk
// that Python immediately reduces cost ~120 s of single-core bond_obs
// plus the cache pressure of materialising the whole 12 GB northstar
// trajectory through RAM.  Here each frame is
// decoded into a thread-local scratch and reduced in place — the full
// coordinate block never exists.

static void reduce_frame(const float* frm, int natoms,
                         const long* idx_h, const long* idx_x,
                         long n_bonds, const double* A,
                         float* raw_out, double* S_out) {
    for (long b = 0; b < n_bonds; b++) {
        const float* h = frm + (size_t)idx_h[b] * 3;
        const float* x = frm + (size_t)idx_x[b] * 3;
        raw_out[b * 3 + 0] = h[0] - x[0];
        raw_out[b * 3 + 1] = h[1] - x[1];
        raw_out[b * 3 + 2] = h[2] - x[2];
    }
    const double* A0 = A;
    const double* A1 = A + natoms;
    const double* A2 = A + 2 * (size_t)natoms;
    double s00 = 0, s01 = 0, s02 = 0, s10 = 0, s11 = 0, s12 = 0,
           s20 = 0, s21 = 0, s22 = 0;
    for (int a = 0; a < natoms; a++) {
        double x = frm[(size_t)a * 3 + 0];
        double y = frm[(size_t)a * 3 + 1];
        double z = frm[(size_t)a * 3 + 2];
        double a0 = A0[a], a1 = A1[a], a2 = A2[a];
        s00 += a0 * x; s01 += a0 * y; s02 += a0 * z;
        s10 += a1 * x; s11 += a1 * y; s12 += a1 * z;
        s20 += a2 * x; s21 += a2 * y; s22 += a2 * z;
    }
    S_out[0] = s00; S_out[1] = s01; S_out[2] = s02;
    S_out[3] = s10; S_out[4] = s11; S_out[5] = s12;
    S_out[6] = s20; S_out[7] = s21; S_out[8] = s22;
}

// In-memory bond-observable reduction over an already-decoded f32
// coordinate block — the SAME per-frame reduction as xtc_next_obs, so
// the host path (ops/orient.bond_obs_host on npz/trr/dcd/... chunks)
// and the fused .xtc ingest produce BIT-IDENTICAL observables (numpy's
// BLAS dgemm sums S in a different f64 order, which flips occasional
// f32-cast ulps and breaks artefact byte-parity between the paths).
void xtc_reduce_obs(const float* xyz, long n_frames, int natoms,
                    const long* idx_h, const long* idx_x, long n_bonds,
                    const double* A, float* raw_diff, double* S,
                    int n_threads) {
    if (n_threads <= 1 || n_frames < 2) {
        for (long f = 0; f < n_frames; f++)
            reduce_frame(xyz + (size_t)f * natoms * 3, natoms, idx_h,
                         idx_x, n_bonds, A,
                         raw_diff + (size_t)f * n_bonds * 3,
                         S + (size_t)f * 9);
        return;
    }
    int T = n_threads;
    if ((long)T > n_frames) T = (int)n_frames;
    long per = (n_frames + T - 1) / T;
    std::vector<std::thread> workers;
    for (int t = 0; t < T; t++) {
        long b0 = (long)t * per;
        long b1 = b0 + per < n_frames ? b0 + per : n_frames;
        if (b0 >= b1) break;
        workers.emplace_back([=]() {
            for (long f = b0; f < b1; f++)
                reduce_frame(xyz + (size_t)f * natoms * 3, natoms, idx_h,
                             idx_x, n_bonds, A,
                             raw_diff + (size_t)f * n_bonds * 3,
                             S + (size_t)f * 9);
        });
    }
    for (auto& w : workers) w.join();
}

// Chunked fused reader: same stream/threading/error semantics as
// xtc_next_mt (offset scan + disjoint frame blocks per worker over
// /proc/self/fd reopens; identical output for any n_threads), but each
// frame lands in a thread-local scratch and only the reduced
// observables are written out.
long xtc_next_obs(void* handle,
                  const long* idx_h, const long* idx_x, long n_bonds,
                  const double* A,
                  float* raw_diff,   // (max_frames, n_bonds, 3)
                  double* S,         // (max_frames, 3, 3)
                  float* times, long max_frames, int n_threads) {
    XtcStream* s = (XtcStream*)handle;
    int natoms = s->natoms;
    if (n_threads <= 1) {
        Reader rd{s->fp};
        FrameHeader h{};
        std::vector<float> frm((size_t)natoms * 3);
        long f = 0;
        while (f < max_frames && !rd.eof()) {
            if (!read_frame(rd, h, frm.data(), natoms))
                return h.natoms > 0 && h.natoms != natoms ? -3 : -4;
            reduce_frame(frm.data(), natoms, idx_h, idx_x, n_bonds, A,
                         raw_diff + (size_t)f * n_bonds * 3,
                         S + (size_t)f * 9);
            times[f] = h.time;
            f++;
        }
        return f;
    }

    std::vector<long> offs;
    offs.reserve((size_t)max_frames);
    Reader rd{s->fp};
    FrameHeader h{};
    long scan_end = 0;
    {
        long pos = ftell(s->fp);
        if (pos < 0) return -4;
        while ((long)offs.size() < max_frames && !rd.eof()) {
            offs.push_back(pos);
            if (!read_frame(rd, h, nullptr)) return -4;
            pos = ftell(s->fp);
            if (pos < 0) return -4;
        }
        scan_end = pos;
    }
    long n = (long)offs.size();
    if (n == 0) return 0;
    int T = n_threads;
    if ((long)T > n) T = (int)n;
    std::vector<long> status((size_t)T, 0);
    std::vector<std::thread> workers;
    const char* path = s->path.data();
    char fdpath[64];
    snprintf(fdpath, sizeof fdpath, "/proc/self/fd/%d", fileno(s->fp));
    long per = (n + T - 1) / T;
    for (int t = 0; t < T; t++) {
        long b0 = (long)t * per;
        long b1 = b0 + per < n ? b0 + per : n;
        if (b0 >= b1) break;
        workers.emplace_back([=, &offs, &status]() {
            FILE* fp = fopen(fdpath, "rb");
            if (!fp) fp = fopen(path, "rb");
            if (!fp) { status[t] = -4; return; }
            Reader wrd{fp};
            FrameHeader wh{};
            std::vector<float> frm((size_t)natoms * 3);
            for (long f = b0; f < b1; f++) {
                if (f == b0 || ftell(fp) != offs[f]) {
                    if (fseek(fp, offs[f], SEEK_SET) != 0) {
                        status[t] = -4;
                        break;
                    }
                }
                if (!read_frame(wrd, wh, frm.data(), natoms)) {
                    status[t] = wh.natoms > 0 && wh.natoms != natoms
                                    ? -3 : -4;
                    break;
                }
                reduce_frame(frm.data(), natoms, idx_h, idx_x, n_bonds, A,
                             raw_diff + (size_t)f * n_bonds * 3,
                             S + (size_t)f * 9);
                times[f] = wh.time;
            }
            fclose(fp);
        });
    }
    for (auto& w : workers) w.join();
    for (int t = 0; t < T; t++)
        if (status[t] != 0) return status[t];
    if (fseek(s->fp, scan_end, SEEK_SET) != 0) return -4;
    return n;
}

int xtc_write(const char* path, const float* xyz, const float* times,
              const float* boxes, long n_frames, int natoms, float precision) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return -1;
    Writer wr{fp};
    for (long f = 0; f < n_frames && wr.ok; f++) {
        write_frame(wr, natoms, (int)f, times ? times[f] : (float)f,
                    boxes ? boxes + (size_t)f * 9 : nullptr,
                    xyz + (size_t)f * natoms * 3, precision);
    }
    int rc = fclose(fp);
    return (wr.ok && rc == 0) ? 0 : -2;  // I/O failure or overflow
}

// Append frames to an existing .xtc (or create it), numbering steps from
// step0.  XTC frames are self-delimiting, so file-level concatenation is
// a valid trajectory — this is the streaming writer used by incremental
// converters (e.g. `spinrelax center` on >RAM trajectories).
int xtc_append(const char* path, const float* xyz, const float* times,
               const float* boxes, long n_frames, int natoms,
               float precision, long step0) {
    FILE* fp = fopen(path, "ab");
    if (!fp) return -1;
    Writer wr{fp};
    for (long f = 0; f < n_frames && wr.ok; f++) {
        write_frame(wr, natoms, (int)(step0 + f),
                    times ? times[f] : (float)(step0 + f),
                    boxes ? boxes + (size_t)f * 9 : nullptr,
                    xyz + (size_t)f * natoms * 3, precision);
    }
    int rc = fclose(fp);
    return (wr.ok && rc == 0) ? 0 : -2;
}
}
