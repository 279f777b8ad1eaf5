// Native host-side IO + pileup for somatic_sniper_tpu.
//
// Replaces the vendored samtools C layer of the reference with a
// TPU-era equivalent: block-parallel BGZF inflate, whole-buffer BAM
// record decode into columnar arrays, and vectorized pileup
// columnarization producing the packed u32 slot entries the device
// kernel consumes (see somatic_sniper_tpu/models/glfgen.py).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).
//
// Reference behaviours replicated:
//  * BGZF container framing       (vendor bgzf.c)
//  * BAM record layout            (vendor bam.c:181 bam_read1)
//  * read ingestion filter        (reference sniper_pileup.c:208)
//  * resolve_cigar column rules   (reference sniper_pileup.c:57-104)
//  * contig-transition read drop  (reference sniper_pileup.c:216 quirk)

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <dlfcn.h>

#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Buffer {
    std::vector<uint8_t> data;
};

static bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize(sz);
    size_t got = fread(out.data(), 1, sz, f);
    fclose(f);
    return got == (size_t)sz;
}

// Load-phase wall-time accumulators (ns), summed across threads/calls:
// 0 file-read, 1 bgzf-header-scan, 2 inflate, 3 record-scan/filter,
// 4 pileup-build, 5 pure-flags.  Cumulative for the process; read by
// sniper_load_counters, never reset (a reader takes deltas).  A
// handful of clock calls per window load.
static std::atomic<int64_t> g_prof[6];

// Inflate counters, cumulative like g_prof: 0 bytes inflated, 1 blocks
// inflated by libdeflate, 2 blocks inflated by zlib (the backend is
// picked at run time, libdeflate_probe), 3 blocks handed to a registered
// card inflater (card_inflate), 4 of those the host inflated again.
// inflate_block and card_inflate count into the calling thread's tally;
// publish_inflate adds a thread's tally to the globals, once per call
// (PublishInflate) and once per spawned worker.
static std::atomic<int64_t> g_inflate[5];

struct InflateTally {
    int64_t bytes = 0, libdeflate = 0, zlib = 0, card = 0, card_redo = 0;
};
static thread_local InflateTally t_inflate;

static void publish_inflate() {
    InflateTally& t = t_inflate;
    if (t.bytes) g_inflate[0].fetch_add(t.bytes);
    if (t.libdeflate) g_inflate[1].fetch_add(t.libdeflate);
    if (t.zlib) g_inflate[2].fetch_add(t.zlib);
    if (t.card) g_inflate[3].fetch_add(t.card);
    if (t.card_redo) g_inflate[4].fetch_add(t.card_redo);
    t = InflateTally();
}

struct PublishInflate {
    ~PublishInflate() { publish_inflate(); }
};

static inline int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

struct ProfSpan {
    int idx;
    int64_t t0;
    explicit ProfSpan(int i) : idx(i), t0(now_ns()) {}
    ~ProfSpan() { g_prof[idx].fetch_add(now_ns() - t0); }
};

static uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}
static uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static int32_t rd_i32(const uint8_t* p) { return (int32_t)rd_u32(p); }

// ---- BGZF ----------------------------------------------------------------

struct BgzfBlock {
    int64_t in_off;    // compressed payload offset (past header)
    int32_t in_size;   // compressed payload size (deflate stream)
    int64_t out_off;   // output offset
    int32_t out_size;  // ISIZE
    int64_t file_off;  // block start offset in the file (BAI voffsets)
};

static bool scan_bgzf(const std::vector<uint8_t>& raw,
                      std::vector<BgzfBlock>& blocks, int64_t& total_out,
                      std::string& err) {
    int64_t pos = 0;
    const int64_t n = (int64_t)raw.size();
    total_out = 0;
    while (pos < n) {
        if (pos + 18 > n || raw[pos] != 0x1f || raw[pos + 1] != 0x8b) {
            err = "bad gzip magic at offset " + std::to_string(pos);
            return false;
        }
        uint16_t xlen = rd_u16(&raw[pos + 10]);
        int64_t extra = pos + 12;
        int64_t extra_end = extra + xlen;
        int bsize = -1;
        while (extra + 4 <= extra_end) {
            uint8_t si1 = raw[extra], si2 = raw[extra + 1];
            uint16_t slen = rd_u16(&raw[extra + 2]);
            if (si1 == 'B' && si2 == 'C' && slen == 2)
                bsize = rd_u16(&raw[extra + 4]) + 1;
            extra += 4 + slen;
        }
        if (bsize < 0) {
            err = "missing BC subfield (not BGZF) at offset " +
                  std::to_string(pos);
            return false;
        }
        int64_t payload = pos + 12 + xlen;
        int32_t comp_size = bsize - (int32_t)(12 + xlen) - 8;
        if (payload + comp_size + 8 > n) {
            err = "truncated BGZF block";
            return false;
        }
        int32_t isize = (int32_t)rd_u32(&raw[pos + bsize - 4]);
        blocks.push_back({payload, comp_size, total_out, isize, pos});
        total_out += isize;
        pos += bsize;
    }
    return true;
}

// libdeflate (when present) decompresses raw DEFLATE blocks 2-3x faster
// than zlib; resolved at runtime via dlopen so the build needs no new
// link dependency and machines without it fall back to zlib.
typedef void* (*ld_alloc_fn)();
typedef void (*ld_free_fn)(void*);
typedef int (*ld_decomp_fn)(void*, const void*, size_t, void*, size_t,
                            size_t*);
static ld_alloc_fn g_ld_alloc = nullptr;
static ld_free_fn g_ld_free = nullptr;
static ld_decomp_fn g_ld_decomp = nullptr;

static void libdeflate_probe() {
    static std::once_flag once;
    std::call_once(once, []() {
        void* h = dlopen("libdeflate.so.0", RTLD_NOW);
        if (!h) h = dlopen("libdeflate.so", RTLD_NOW);
        if (!h) return;
        auto a = (ld_alloc_fn)dlsym(h, "libdeflate_alloc_decompressor");
        auto f = (ld_free_fn)dlsym(h, "libdeflate_free_decompressor");
        auto d = (ld_decomp_fn)dlsym(h, "libdeflate_deflate_decompress");
        if (a && d) {
            g_ld_alloc = a;
            g_ld_free = f;
            g_ld_decomp = d;
        }
    });
}

// thread-local decompressor caches, freed at thread exit (worker
// threads come and go per load; without the destructors every exited
// thread leaked its decompressor state)
struct LdDecHolder {
    void* p = nullptr;
    ~LdDecHolder() {
        if (p && g_ld_free) g_ld_free(p);
    }
};

struct ZStreamHolder {
    z_stream* z = nullptr;
    ~ZStreamHolder() {
        if (z) {
            inflateEnd(z);
            delete z;
        }
    }
};

static bool inflate_block(const uint8_t* src, int32_t src_len, uint8_t* dst,
                          int32_t dst_len) {
    if (g_ld_decomp) {
        // one decompressor per worker thread, reused across blocks
        static thread_local LdDecHolder dec;
        if (!dec.p) dec.p = g_ld_alloc();
        if (dec.p) {
            size_t actual = 0;
            int r = g_ld_decomp(dec.p, src, (size_t)src_len, dst,
                                (size_t)dst_len, &actual);
            ++t_inflate.libdeflate;
            t_inflate.bytes += (int64_t)actual;
            return r == 0 /* LIBDEFLATE_SUCCESS */ &&
                   actual == (size_t)dst_len;
        }
    }
    // zlib fallback: thread-local stream reused via inflateReset2 (a
    // fresh inflateInit2/inflateEnd per 64 KB block costs real time)
    static thread_local ZStreamHolder zh;
    z_stream*& zsp = zh.z;
    if (!zsp) {
        zsp = new z_stream();
        memset(zsp, 0, sizeof(*zsp));
        if (inflateInit2(zsp, -15) != Z_OK) {
            delete zsp;
            zsp = nullptr;
            return false;
        }
    }
    if (inflateReset2(zsp, -15) != Z_OK) return false;
    zsp->next_in = const_cast<uint8_t*>(src);
    zsp->avail_in = src_len;
    zsp->next_out = dst;
    zsp->avail_out = dst_len;
    int ret = inflate(zsp, Z_FINISH);
    ++t_inflate.zlib;
    t_inflate.bytes += (int64_t)(dst_len - zsp->avail_out);
    return ret == Z_STREAM_END && zsp->avail_out == 0;
}

// A card inflater (the port's sniper_card_inflate), registered by the
// windowed driver when its device is a card (sniper_set_card_inflate).
// Block b's raw DEFLATE stream is in_len[b] bytes at comp + in_off[b];
// its output (isize[b] bytes, CRC32 crc[b]) goes to out + out_off[b]
// where status[b] comes back 0.  Returns 0, or nonzero (a CUDA error) when
// the call failed as a whole.
typedef int (*CardInflateFn)(int device, const void* comp, long long comp_len,
                             int n_blocks, const void* in_off,
                             const void* in_len, const void* isize,
                             const void* crc, void* out, const void* out_off,
                             void* status);
static std::atomic<CardInflateFn> g_card_inflate{nullptr};
static std::atomic<int> g_card_device{0};
// Fewer blocks than this stay on the host: a card call waits about 5 ms
// (one block's serial decode), which zlib matches at ~15 blocks of 64 KB
// (0.34 ms a block; H100 host, PERF.md).
static const int kCardMinBlocks = 16;

// A card pileup builder (the port's sniper_card_pileup), registered by the
// windowed driver beside the card inflater (sniper_set_card_pileup): a
// region load's pileup and its pure-reference flags, built from the
// region's inflated bytes and the body offsets of the records pass 1 kept
// (card_pileup).  It returns the arrays in a buffer of its own, which the
// pileup gives back to its release function when freed.  Returns 0; a
// negative number where the host is to build the region; or a CUDA error
// (the load fails).
typedef int (*CardPileupFn)(int device, const void* bytes, long long n_bytes,
                            const void* rec, int n_reads, int tid,
                            long long lo, long long hi, long long max_len,
                            const void* ref, long long n_ref, const void* fk,
                            const void* gmin, double margin, int fused,
                            void* out, void* counts);
typedef void (*CardReleaseFn)(void* buffer);
static std::atomic<CardPileupFn> g_card_pileup{nullptr};
static std::atomic<CardReleaseFn> g_card_release{nullptr};
// region loads whose pileup the card built, and those the host built (one
// atomic add a region, read by sniper_load_counters)
static std::atomic<int64_t> g_regions[2];

// Hand a region's blocks (those with output) to the card inflater in one
// call, and leave in ``blocks`` the ones the card refused, for the host to
// inflate as it would without a card: a bad status, or a CRC32 or ISIZE
// the output does not meet.  The CRC32 is the 4 bytes the BGZF trailer
// holds right after the block's DEFLATE stream.  Fewer than
// kCardMinBlocks blocks are all left to the host.  A call that fails as a
// whole (a CUDA error) fails the load: false, with ``err`` set.
// ``refused``: the blocks the card refused.
static bool card_inflate(CardInflateFn fn, const std::vector<uint8_t>& comp,
                         std::vector<BgzfBlock>& blocks, uint8_t* out,
                         int64_t& refused, std::string& err) {
    std::vector<BgzfBlock> sent;
    for (const BgzfBlock& b : blocks)
        if (b.out_size != 0) sent.push_back(b);
    const int n = (int)sent.size();
    if (n < kCardMinBlocks) return true;
    std::vector<int64_t> in_off(n), out_off(n);
    std::vector<int32_t> in_len(n), isize(n), status(n, -1);
    std::vector<uint32_t> crc(n);
    for (int i = 0; i < n; ++i) {
        const BgzfBlock& b = sent[i];
        in_off[i] = b.in_off;
        in_len[i] = b.in_size;
        out_off[i] = b.out_off;
        isize[i] = b.out_size;
        crc[i] = rd_u32(&comp[b.in_off + b.in_size]);
    }
    const int rc = fn(g_card_device.load(), comp.data(),
                      (long long)comp.size(), n, in_off.data(),
                      in_len.data(), isize.data(), crc.data(), out,
                      out_off.data(), status.data());
    if (rc != 0) {
        err = "BGZF inflate failure (region, card: CUDA error " +
              std::to_string(rc) + ")";
        return false;
    }
    blocks.clear();
    for (int i = 0; i < n; ++i) {
        if (status[i] != 0)
            blocks.push_back(sent[i]);
        else
            t_inflate.bytes += isize[i];
    }
    refused = (int64_t)blocks.size();
    t_inflate.card += n;
    t_inflate.card_redo += refused;
    return true;
}

static bool bgzf_decompress(const std::vector<uint8_t>& raw,
                            std::vector<uint8_t>& out, int n_threads,
                            std::string& err) {
    std::vector<BgzfBlock> blocks;
    int64_t total = 0;
    if (!scan_bgzf(raw, blocks, total, err)) return false;
    out.resize(total);
    if (n_threads < 1) n_threads = 1;
    libdeflate_probe();
    PublishInflate publish;
    std::atomic<size_t> next(0);
    std::atomic<bool> ok(true);
    auto worker = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blocks.size()) break;
            const BgzfBlock& b = blocks[i];
            if (b.out_size == 0) continue;
            if (!inflate_block(&raw[b.in_off], b.in_size, &out[b.out_off],
                               b.out_size))
                ok.store(false);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < n_threads; ++t)
        ts.emplace_back([&]() { worker(); publish_inflate(); });
    worker();
    for (auto& t : ts) t.join();
    if (!ok.load()) {
        err = "BGZF inflate failure";
        return false;
    }
    return true;
}

}  // namespace

// ---- public structs (C ABI) ----------------------------------------------

extern "C" {

struct NativeBam {
    int64_t n_reads;
    int64_t n_cigar_total;
    int64_t n_seq_total;
    int32_t* tid;
    int32_t* pos;
    uint16_t* flag;
    uint8_t* mapq;
    uint16_t* n_cigar;
    int32_t* l_qseq;
    uint32_t* cigar;      // flattened
    int64_t* cigar_off;   // [n_reads + 1]
    uint8_t* seq;         // flattened 4-bit codes (one per base)
    uint8_t* qual;        // flattened
    int64_t* seq_off;     // [n_reads + 1]
    // header
    char* text;
    int32_t n_ref;
    int32_t* ref_len;
    char* ref_names;      // concatenated, NUL-separated
    int64_t ref_names_len;
    // internal
    void* _storage;
};

struct NativePileup {
    int64_t n_entries;
    int64_t n_cols;
    int64_t* keys;     // [n_entries] (tid<<40|pos), sorted
    uint32_t* slots;   // [n_entries] packed
    int64_t* ukeys;    // [n_cols]
    int64_t* offsets;  // [n_cols + 1]
    uint8_t* pure;     // [n_cols] pure-ref margin flags, or NULL
    void* _storage;
};

// Header-only view (bam_read_header); the fused load path returns a
// bare NativePileup, so header fields travel separately.
struct NativeBamHeader {
    char* text;
    int32_t n_ref;
    int32_t* ref_len;
    char* ref_names;  // concatenated, NUL-separated
    int64_t ref_names_len;
    void* _storage;
};

}  // extern "C"

namespace {

struct BamStorage {
    std::vector<int32_t> tid, pos, l_qseq;
    std::vector<uint16_t> flag, n_cigar;
    std::vector<uint8_t> mapq, seq, qual;
    std::vector<uint32_t> cigar;
    std::vector<int64_t> cigar_off, seq_off;
    std::string text;
    std::vector<int32_t> ref_len;
    std::string ref_names;
    int32_t n_ref = 0;
};

struct PileupStorage {
    std::vector<int64_t> keys, ukeys, offsets;
    std::vector<uint32_t> slots;
    std::vector<uint8_t> pure;
    // a card builder's buffer holding the arrays instead, and its release
    void* card_buffer = nullptr;
    void (*card_release)(void*) = nullptr;
    ~PileupStorage() {
        if (card_buffer) card_release(card_buffer);
    }
};

struct HeaderStorage {
    std::string text;
    std::vector<int32_t> ref_len;
    std::string ref_names;  // concatenated, NUL-separated
    int32_t n_ref = 0;
};

struct RecTableStorage {
    std::vector<int64_t> voff, pos, end;
    std::vector<int32_t> tid;
};

// Parse the BAM header section of an inflated stream (magic, SAM text,
// reference dictionary; vendor bam.c:90 bam_header_read).  Returns the
// offset of the first alignment record, -1 if the buffer ends inside
// the header (caller should supply more bytes), or -2 if malformed.
// ``hs`` may be NULL to only locate the record start.
static int64_t parse_bam_header(const uint8_t* buf, int64_t n,
                                HeaderStorage* hs) {
    if (n < 8) return -1;
    if (memcmp(buf, "BAM\1", 4) != 0) return -2;
    int64_t p = 4;
    int32_t l_text = rd_i32(buf + p);
    p += 4;
    if (l_text < 0) return -2;
    if (p + (int64_t)l_text + 4 > n) return -1;
    if (hs) {
        hs->text.assign((const char*)buf + p, (size_t)l_text);
        size_t z = hs->text.find('\0');  // trim trailing NULs
        if (z != std::string::npos) hs->text.resize(z);
    }
    p += l_text;
    int32_t n_ref = rd_i32(buf + p);
    p += 4;
    if (n_ref < 0) return -2;
    if (hs) hs->n_ref = n_ref;
    for (int32_t i = 0; i < n_ref; ++i) {
        if (p + 4 > n) return -1;
        int32_t l_name = rd_i32(buf + p);
        p += 4;
        if (l_name < 0) return -2;
        if (p + (int64_t)l_name + 4 > n) return -1;
        if (hs) hs->ref_names.append((const char*)buf + p, (size_t)l_name);
        p += l_name;
        if (hs) hs->ref_len.push_back(rd_i32(buf + p));
        p += 4;
    }
    return p;
}

// defined below (same unnamed namespace)
static void decode_record(BamStorage* st, const uint8_t* r);
static NativeBam* finish_bam(BamStorage* st);

// A corrupted record can claim name/cigar/seq lengths that overrun its
// own block_size (and, downstream, absurd allocation sizes); reject the
// file instead of reading out of the record.
static bool record_layout_ok(const uint8_t* r, int32_t bs) {
    if (bs < 32) return false;
    const int32_t l_read_name = r[8];
    const int32_t n_cigar = rd_u16(r + 12);
    const int64_t l_seq = rd_i32(r + 16);
    if (l_seq < 0) return false;
    const int64_t need = 32 + l_read_name + 4 * (int64_t)n_cigar +
                         (l_seq + 1) / 2 + l_seq;
    return need <= bs;
}

}  // namespace

extern "C" {

static thread_local std::string g_err;

const char* sniper_last_error() { return g_err.c_str(); }

NativeBam* bam_load(const char* path, int n_threads) {
    try {
    std::vector<uint8_t> raw;
    if (!read_file(path, raw)) {
        g_err = std::string("cannot read ") + path;
        return nullptr;
    }
    std::vector<uint8_t> buf;
    if (!bgzf_decompress(raw, buf, n_threads, g_err)) return nullptr;
    raw.clear();
    raw.shrink_to_fit();

    HeaderStorage hs;
    int64_t p = parse_bam_header(buf.data(), (int64_t)buf.size(), &hs);
    if (p < 0) {
        g_err = p == -1 ? "truncated BAM header"
                        : "not a BAM file (bad magic)";
        return nullptr;
    }
    auto* st = new BamStorage();
    st->text = std::move(hs.text);
    st->ref_len = std::move(hs.ref_len);
    st->ref_names = std::move(hs.ref_names);
    st->n_ref = hs.n_ref;

    const int64_t n = (int64_t)buf.size();
    // rough record-count estimate for capacity reservations (a typical
    // short-read record is ~100 bytes of stream); seq unpacks to ~2x its
    // packed bytes but the stream also carries names/cigars/quals, so
    // buf.size() over-reserves mildly and avoids doubling reallocations
    const size_t est = (size_t)((n - p) / 100) + 16;
    st->tid.reserve(est);
    st->pos.reserve(est);
    st->l_qseq.reserve(est);
    st->flag.reserve(est);
    st->n_cigar.reserve(est);
    st->mapq.reserve(est);
    st->cigar_off.reserve(est + 1);
    st->seq_off.reserve(est + 1);
    st->seq.reserve((size_t)n);
    st->qual.reserve((size_t)n / 2);
    while (p + 4 <= n) {
        int32_t bs = rd_i32(&buf[p]);
        if (bs < 32 || p + 4 + bs > n ||
            !record_layout_ok(&buf[p + 4], bs)) {
            g_err = "truncated or corrupt BAM record";
            delete st;
            return nullptr;
        }
        decode_record(st, &buf[p + 4]);
        p += 4 + bs;
    }
    if (p != n) {
        g_err = "trailing bytes after last BAM record";
        delete st;
        return nullptr;
    }
    return finish_bam(st);
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

void bam_destroy(NativeBam* nb) {
    if (!nb) return;
    delete (BamStorage*)nb->_storage;
    delete nb;
}

}  // extern "C"

namespace {

// Decode one raw BAM alignment record into the columnar storage.
static void decode_record(BamStorage* st, const uint8_t* r) {
    int32_t tid = rd_i32(r + 0);
    int32_t pos = rd_i32(r + 4);
    uint8_t l_read_name = r[8];
    uint8_t mapq = r[9];
    uint16_t n_cigar = rd_u16(r + 12);
    uint16_t flag = rd_u16(r + 14);
    int32_t l_seq = rd_i32(r + 16);
    st->tid.push_back(tid);
    st->pos.push_back(pos);
    st->mapq.push_back(mapq);
    st->n_cigar.push_back(n_cigar);
    st->flag.push_back(flag);
    st->l_qseq.push_back(l_seq);
    const uint8_t* cg = r + 32 + l_read_name;
    for (int k = 0; k < n_cigar; ++k)
        st->cigar.push_back(rd_u32(cg + 4 * k));
    st->cigar_off.push_back((int64_t)st->cigar.size());
    const uint8_t* sq = cg + 4 * n_cigar;
    // bulk nibble unpack (a per-base push_back pays a capacity check and
    // periodic whole-vector reallocation copies across ~30M bases)
    size_t soff = st->seq.size();
    st->seq.resize(soff + (size_t)l_seq);
    uint8_t* dst = st->seq.data() + soff;
    int32_t pairs = l_seq / 2;
    for (int32_t k = 0; k < pairs; ++k) {
        uint8_t byte = sq[k];
        dst[2 * k] = byte >> 4;
        dst[2 * k + 1] = byte & 0xF;
    }
    if (l_seq & 1) dst[l_seq - 1] = sq[pairs] >> 4;
    const uint8_t* qu = sq + (l_seq + 1) / 2;
    st->qual.insert(st->qual.end(), qu, qu + l_seq);
    st->seq_off.push_back((int64_t)st->seq.size());
}

static NativeBam* finish_bam(BamStorage* st) {
    st->cigar_off.insert(st->cigar_off.begin(), 0);
    st->seq_off.insert(st->seq_off.begin(), 0);
    auto* nb = new NativeBam();
    nb->n_reads = (int64_t)st->tid.size();
    nb->n_cigar_total = (int64_t)st->cigar.size();
    nb->n_seq_total = (int64_t)st->seq.size();
    nb->tid = st->tid.data();
    nb->pos = st->pos.data();
    nb->flag = st->flag.data();
    nb->mapq = st->mapq.data();
    nb->n_cigar = st->n_cigar.data();
    nb->l_qseq = st->l_qseq.data();
    nb->cigar = st->cigar.data();
    nb->cigar_off = st->cigar_off.data();
    nb->seq = st->seq.data();
    nb->qual = st->qual.data();
    nb->seq_off = st->seq_off.data();
    nb->text = const_cast<char*>(st->text.c_str());
    nb->n_ref = st->n_ref;
    nb->ref_len = st->ref_len.data();
    nb->ref_names = const_cast<char*>(st->ref_names.data());
    nb->ref_names_len = (int64_t)st->ref_names.size();
    nb->_storage = st;
    return nb;
}

static int64_t rec_ref_span(const uint8_t* r) {
    uint8_t l_read_name = r[8];
    uint16_t n_cigar = rd_u16(r + 12);
    const uint8_t* cg = r + 32 + l_read_name;
    int64_t span = 0;
    for (int k = 0; k < n_cigar; ++k) {
        uint32_t c = rd_u32(cg + 4 * k);
        uint32_t op = c & 0xF;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            span += c >> 4;
    }
    return span > 0 ? span : 1;
}

// Shared core of the region loaders: inflate the BAI virtual-offset
// chunk spans of one region query into ``all`` and collect the body
// offsets (into ``all``) of records on ``tid`` overlapping [beg, end).
// Chunk semantics follow vendor bam_index.c: a virtual offset packs
// (compressed block offset << 16 | within-block offset); a chunk may
// start/end mid-block.  Every chunk is read and scanned first, then all
// their blocks are inflated at once (one call to a card inflater, when
// one is registered), then each chunk's records are collected.
// t_region_refused: the blocks a card inflater refused.
static thread_local int64_t t_region_refused = 0;
static bool region_scan(const char* path, const int64_t* chunks,
                        int64_t n_chunks, int32_t tid, int64_t beg,
                        int64_t end, int n_threads,
                        std::vector<uint8_t>& all,
                        std::vector<int64_t>& kept, std::string& err) {
    FILE* f = fopen(path, "rb");
    if (!f) {
        err = std::string("cannot read ") + path;
        return false;
    }
    fseek(f, 0, SEEK_END);
    const int64_t fsize = ftell(f);
    if (n_threads < 1) n_threads = 1;
    libdeflate_probe();
    PublishInflate publish;
    t_region_refused = 0;
    // a chunk's place in ``all`` and where its records start and stop
    struct ChunkSpan {
        int64_t abase, total, last_block_usize, c_beg, c_end;
        int32_t u_beg, u_end;
    };
    std::vector<ChunkSpan> spans;
    std::vector<uint8_t> comp_all;   // every chunk's span, one after another
    std::vector<BgzfBlock> blocks;   // in_off into comp_all, out_off into all
    // one allocation each for the spans and the inflated bytes (a vector
    // grown chunk by chunk doubles its capacity)
    int64_t comp_bytes = 0;
    for (int64_t ci = 0; ci < n_chunks; ++ci) {
        const int64_t c_beg = chunks[2 * ci] >> 16;
        const int64_t c_end = chunks[2 * ci + 1] >> 16;
        const int64_t last = (chunks[2 * ci + 1] & 0xFFFF) ? c_end : c_end - 1;
        const int64_t span_end = std::min(last + 0x10000 + 28, fsize);
        if (span_end > c_beg) comp_bytes += span_end - c_beg;
    }
    comp_all.reserve((size_t)comp_bytes);
    const int64_t all_base = (int64_t)all.size();
    int64_t all_bytes = 0;
    for (int64_t ci = 0; ci < n_chunks; ++ci) {
        int64_t vbeg = chunks[2 * ci], vend = chunks[2 * ci + 1];
        int64_t c_beg = vbeg >> 16, c_end = vend >> 16;
        int32_t u_beg = (int32_t)(vbeg & 0xFFFF);
        int32_t u_end = (int32_t)(vend & 0xFFFF);
        // one read of the whole compressed span (the last needed
        // block's size is unknown until its header is parsed, so read
        // up to the 64 KB BGZF ceiling past c_end), then scan block
        // headers in memory — thousands of tiny freads per window cost
        // real syscall time
        int64_t last_needed = u_end > 0 ? c_end : c_end - 1;
        int64_t span_end = last_needed + 0x10000 + 28;
        if (span_end > fsize) span_end = fsize;
        if (span_end <= c_beg) continue;
        const int64_t cbase = (int64_t)comp_all.size();
        comp_all.resize((size_t)(cbase + span_end - c_beg));
        const uint8_t* comp = &comp_all[cbase];
        const int64_t n_comp = span_end - c_beg;
        {
            ProfSpan ps(0);
            fseek(f, c_beg, SEEK_SET);
            if (fread(&comp_all[cbase], 1, n_comp, f) != (size_t)n_comp) {
                err = "short read (region span)";
                fclose(f);
                return false;
            }
        }
        int64_t last_block_usize = 0;
        int64_t total = 0;
        const int64_t abase = all_base + all_bytes;
        {
            ProfSpan ps(1);
            int64_t off = c_beg;
            while (off <= last_needed) {
                const int64_t rel = off - c_beg;
                if (rel + 18 > n_comp || comp[rel] != 0x1f ||
                    comp[rel + 1] != 0x8b)
                    break;
                uint16_t xlen = rd_u16(&comp[rel + 10]);
                int bsize = -1;
                int64_t ep = rel + 12;
                const int64_t ep_end = ep + xlen;
                if (ep_end > n_comp) break;
                while (ep + 4 <= ep_end) {
                    if (comp[ep] == 'B' && comp[ep + 1] == 'C' &&
                        rd_u16(&comp[ep + 2]) == 2)
                        bsize = rd_u16(&comp[ep + 4]) + 1;
                    ep += 4 + rd_u16(&comp[ep + 2]);
                }
                if (bsize < 0) break;
                int32_t comp_size = bsize - (int32_t)(12 + xlen) - 8;
                if (rel + bsize > n_comp || comp_size < 0) break;
                int32_t isize =
                    (int32_t)rd_u32(&comp[rel + bsize - 4]);
                blocks.push_back({cbase + rel + 12 + xlen, comp_size,
                                  abase + total, isize, off});
                total += isize;
                if (off == c_end) last_block_usize = isize;
                off += bsize;
            }
        }
        all_bytes += total;
        spans.push_back({abase, total, last_block_usize, c_beg, c_end, u_beg,
                         u_end});
    }
    all.resize((size_t)(all_base + all_bytes));
    // with a card inflater registered, the host inflates only the blocks
    // the card refused
    if (CardInflateFn card = g_card_inflate.load()) {
        ProfSpan ps(2);
        if (!card_inflate(card, comp_all, blocks, all.data(),
                          t_region_refused, err)) {
            fclose(f);
            return false;
        }
    }
    std::atomic<size_t> next(0);
    std::atomic<bool> ok(true);
    auto worker = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blocks.size()) break;
            const BgzfBlock& b = blocks[i];
            if (b.out_size == 0) continue;
            if (!inflate_block(&comp_all[b.in_off], b.in_size,
                               &all[b.out_off], b.out_size))
                ok.store(false);
        }
    };
    {
        ProfSpan ps(2);
        std::vector<std::thread> ts;
        for (int t = 1; t < n_threads && (size_t)t < blocks.size(); ++t)
            ts.emplace_back([&]() { worker(); publish_inflate(); });
        worker();
        for (auto& t : ts) t.join();
    }
    if (!ok.load()) {
        err = "BGZF inflate failure (region)";
        fclose(f);
        return false;
    }
    fclose(f);
    for (const ChunkSpan& c : spans) {
        const int64_t abase = c.abase, total = c.total;
        const int64_t last_block_usize = c.last_block_usize;
        const int64_t c_beg = c.c_beg, c_end = c.c_end;
        const int32_t u_beg = c.u_beg, u_end = c.u_end;
        // collect records in [u_beg, end-of-chunk minus trailing cut)
        ProfSpan ps3(3);
        int64_t p = abase + u_beg;
        int64_t n = abase + total;
        // the chunk may end inside the last block at u_end
        int64_t stop = n;
        if (u_end > 0 && last_block_usize > 0)
            stop = n - last_block_usize + u_end;
        else if (u_end > 0 && c_beg == c_end)
            stop = abase + u_end;
        while (p + 4 <= stop) {
            int32_t bs = rd_i32(&all[p]);
            if (p + 4 + bs > n) break;  // record clipped by chunk end
            if (bs < 32 || !record_layout_ok(&all[p + 4], bs)) {
                err = "truncated or corrupt BAM record";
                return false;
            }
            const uint8_t* r = &all[p + 4];
            int32_t rtid = rd_i32(r + 0);
            int64_t rpos = rd_i32(r + 4);
            // records starting inside the region always overlap; the
            // CIGAR span walk is only needed for boundary straddlers
            if (rtid == tid && rpos < end &&
                (rpos >= beg || rpos + rec_ref_span(r) > beg))
                kept.push_back(p + 4);
            if (rtid > tid || (rtid == tid && rpos >= end)) break;
            p += 4 + bs;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Region load via BAI virtual-offset chunks (region sharding path; the
// reference streams whole files — SURVEY.md §2.2 calls out that sharded
// readers need the index).  ``chunks`` is a flattened [n_chunks, 2] i64
// array of merged (vbeg, vend) virtual offsets from the Python BAI
// layer; only those compressed byte ranges are read and inflated.
// Returns reads of ``tid`` overlapping [beg, end) — no header fields.
NativeBam* bam_load_region(const char* path, const int64_t* chunks,
                           int64_t n_chunks, int32_t tid, int64_t beg,
                           int64_t end, int n_threads) {
    try {
    std::vector<uint8_t> all;
    std::vector<int64_t> kept;
    if (!region_scan(path, chunks, n_chunks, tid, beg, end, n_threads,
                     all, kept, g_err))
        return nullptr;
    auto* st = new BamStorage();
    for (int64_t off : kept) decode_record(st, &all[off]);
    return finish_bam(st);
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

// Fused region load (the windowed/sharded production path): inflate
// the BAI chunk spans, collect overlapping record offsets, and build
// the window-clipped pileup straight off the record bytes — no
// intermediate NativeBam (see bam_load_pileup).  ``ref16`` != NULL
// additionally computes the fused pure-reference margin flags.
NativePileup* bam_load_region_pileup(
    const char* path, const int64_t* chunks, int64_t n_chunks,
    int32_t tid, int64_t beg, int64_t end, int n_threads, int flag_mask,
    int mapq_thresh, int64_t drop_first_end_le, const uint8_t* ref16,
    const int64_t* ref_off, int32_t n_ref, const double* fk,
    const double* gmin, double margin);

// Header-only read: inflates BGZF blocks from the file start only until
// the header section (vendor bam.c:90) is complete — the fused load
// path (bam_load_pileup) returns a bare pileup, so callers fetch header
// metadata through this without paying a whole-file inflate.
NativeBamHeader* bam_read_header(const char* path) {
    try {
    FILE* f = fopen(path, "rb");
    if (!f) {
        g_err = std::string("cannot read ") + path;
        return nullptr;
    }
    libdeflate_probe();
    PublishInflate publish;
    std::vector<uint8_t> buf;
    int64_t rc;
    for (;;) {
        rc = parse_bam_header(buf.data(), (int64_t)buf.size(), nullptr);
        if (rc != -1) break;  // complete (>=0) or malformed (-2)
        // inflate one more block
        uint8_t hdr[12];
        if (fread(hdr, 1, 12, f) != 12) break;  // EOF inside header
        if (hdr[0] != 0x1f || hdr[1] != 0x8b) {
            rc = -2;
            break;
        }
        uint16_t xlen = rd_u16(hdr + 10);
        std::vector<uint8_t> extra(xlen);
        if (fread(extra.data(), 1, xlen, f) != xlen) break;
        int bsize = -1;
        int64_t ep = 0;
        while (ep + 4 <= (int64_t)xlen) {
            if (extra[ep] == 'B' && extra[ep + 1] == 'C' &&
                rd_u16(&extra[ep + 2]) == 2)
                bsize = rd_u16(&extra[ep + 4]) + 1;
            ep += 4 + rd_u16(&extra[ep + 2]);
        }
        if (bsize < 0) {
            rc = -2;
            break;
        }
        int32_t comp_size = bsize - (int32_t)(12 + xlen) - 8;
        if (comp_size < 0) {
            rc = -2;
            break;
        }
        std::vector<uint8_t> comp((size_t)comp_size + 8);
        if (fread(comp.data(), 1, comp.size(), f) != comp.size()) break;
        int32_t isize = (int32_t)rd_u32(comp.data() + comp_size + 4);
        if (isize == 0) break;  // EOF marker before header end
        size_t base = buf.size();
        buf.resize(base + (size_t)isize);
        if (!inflate_block(comp.data(), comp_size, buf.data() + base,
                           isize)) {
            rc = -2;
            break;
        }
    }
    fclose(f);
    if (rc < 0) {
        g_err = rc == -2 ? "not a BAM file (bad magic/header)"
                         : "truncated BAM header";
        return nullptr;
    }
    auto* hs = new HeaderStorage();
    parse_bam_header(buf.data(), (int64_t)buf.size(), hs);
    auto* h = new NativeBamHeader();
    h->text = const_cast<char*>(hs->text.c_str());
    h->n_ref = hs->n_ref;
    h->ref_len = hs->ref_len.data();
    h->ref_names = const_cast<char*>(hs->ref_names.data());
    h->ref_names_len = (int64_t)hs->ref_names.size();
    h->_storage = hs;
    return h;
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

void bam_header_destroy(NativeBamHeader* h) {
    if (!h) return;
    delete (HeaderStorage*)h->_storage;
    delete h;
}

// Per-record index table for BAI construction (equivalent data to one
// pass of `samtools index`): virtual offset, tid, pos, reference end
// per alignment record.  The Python layer vectorizes the binning; this
// replaces a per-record Python decode that dominated index builds at
// scale.  Returns the record count (-1 on error); arrays are
// caller-allocated with capacity `cap` (pass cap == 0 with n_out to
// query the count first... simpler: caller sizes by file heuristic and
// retries; in practice we return an exact count via a first cheap scan).
struct NativeRecTable {
    int64_t n;
    int64_t end_voff;   // virtual offset just past the last record
    int64_t* voff;
    int32_t* tid;
    int64_t* pos;
    int64_t* end;
    void* _storage;
};

NativeRecTable* bam_record_table(const char* path, int n_threads) {
    try {
    std::vector<uint8_t> raw;
    if (!read_file(path, raw)) {
        g_err = std::string("cannot read ") + path;
        return nullptr;
    }
    std::vector<BgzfBlock> blocks;
    int64_t total = 0;
    if (!scan_bgzf(raw, blocks, total, g_err)) return nullptr;
    std::vector<uint8_t> buf((size_t)total);
    if (n_threads < 1) n_threads = 1;
    libdeflate_probe();
    PublishInflate publish;
    {
        std::atomic<size_t> next(0);
        std::atomic<bool> ok(true);
        auto worker = [&]() {
            for (;;) {
                size_t i = next.fetch_add(1);
                if (i >= blocks.size()) break;
                const BgzfBlock& b = blocks[i];
                if (b.out_size == 0) continue;
                if (!inflate_block(&raw[b.in_off], b.in_size,
                                   &buf[b.out_off], b.out_size))
                    ok.store(false);
            }
        };
        std::vector<std::thread> ts;
        for (int t = 1; t < n_threads; ++t)
            ts.emplace_back([&]() { worker(); publish_inflate(); });
        worker();
        for (auto& t : ts) t.join();
        if (!ok.load()) {
            g_err = "BGZF inflate failure";
            return nullptr;
        }
    }
    raw.clear();
    raw.shrink_to_fit();
    int64_t p = parse_bam_header(buf.data(), (int64_t)buf.size(), nullptr);
    if (p < 0) {
        g_err = p == -1 ? "truncated BAM header"
                        : "not a BAM file (bad magic)";
        return nullptr;
    }
    auto* st = new RecTableStorage();
    const int64_t n = (int64_t)buf.size();
    const size_t est = (size_t)((n - p) / 100) + 16;
    st->voff.reserve(est);
    st->tid.reserve(est);
    st->pos.reserve(est);
    st->end.reserve(est);
    // map uncompressed offset -> virtual offset via the block table
    size_t bi = 0;
    auto voff_of = [&](int64_t up) {
        while (bi + 1 < blocks.size() &&
               blocks[bi + 1].out_off <= up)
            ++bi;
        return (blocks[bi].file_off << 16) | (up - blocks[bi].out_off);
    };
    while (p + 4 <= n) {
        int32_t bs = rd_i32(&buf[p]);
        if (bs < 32 || p + 4 + bs > n ||
            !record_layout_ok(&buf[p + 4], bs)) {
            g_err = "truncated or corrupt BAM record";
            delete st;
            return nullptr;
        }
        const uint8_t* r = &buf[p + 4];
        st->voff.push_back(voff_of(p));
        st->tid.push_back(rd_i32(r));
        int64_t pos = rd_i32(r + 4);
        st->pos.push_back(pos);
        st->end.push_back(pos + rec_ref_span(r));
        p += 4 + bs;
    }
    auto* rt = new NativeRecTable();
    rt->n = (int64_t)st->voff.size();
    // just past the last block's compressed end (matches the Python
    // builder's end-of-file virtual offset)
    rt->end_voff = blocks.empty()
                       ? 0
                       : ((blocks.back().in_off + blocks.back().in_size +
                           8) << 16);
    rt->voff = st->voff.data();
    rt->tid = st->tid.data();
    rt->pos = st->pos.data();
    rt->end = st->end.data();
    rt->_storage = st;
    return rt;
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

void rec_table_destroy(NativeRecTable* rt) {
    if (!rt) return;
    delete (RecTableStorage*)rt->_storage;
    delete rt;
}

// CIGAR ops (vendor bam.h:128-148); samtools-0.1.6 ignores '='/'X'.
enum { CMATCH = 0, CINS = 1, CDEL = 2, CREF_SKIP = 3, CSOFT = 4 };

}  // extern "C"

namespace {

// Read-array accessors for the pileup build.  The build is templated
// over these so the same code runs off decoded NativeBam arrays
// (ArrayReads) or directly off the inflated BAM byte stream (BufReads)
// — the latter skips materializing per-base seq/qual/cigar arrays when
// the caller only wants the pileup (the production load path).
struct ArrayReads {
    const NativeBam* nb;
    int64_t n() const { return nb->n_reads; }
    int32_t tid(int64_t r) const { return nb->tid[r]; }
    int64_t pos(int64_t r) const { return nb->pos[r]; }
    uint16_t flag(int64_t r) const { return nb->flag[r]; }
    uint8_t mapq(int64_t r) const { return nb->mapq[r]; }
    int32_t l_qseq(int64_t r) const { return nb->l_qseq[r]; }
    int64_t cig_n(int64_t r) const {
        return nb->cigar_off[r + 1] - nb->cigar_off[r];
    }
    uint32_t cig(int64_t r, int64_t k) const {
        return nb->cigar[nb->cigar_off[r] + k];
    }
    struct SeqView {
        const uint8_t* sq;  // one 4-bit code per byte (unpacked)
        const uint8_t* qu;
        uint8_t base4(int64_t qp) const { return sq[qp]; }
        uint8_t qual(int64_t qp) const { return qu[qp]; }
    };
    SeqView seqview(int64_t r) const {
        int64_t so = nb->seq_off[r];
        return {nb->seq + so, nb->qual + so};
    }
};

// Records in the raw (inflated) BAM stream: fixed fields per vendor
// bam.c:181 layout — tid:0 pos:4 l_read_name:8 mapq:9 n_cigar:12
// flag:14 l_seq:16, then name, cigar u32s, 4-bit packed seq, qual.
struct BufReads {
    const uint8_t* buf;
    const int64_t* off;  // [n] record body offsets (past block_size)
    int64_t n_;
    const uint8_t* body(int64_t r) const { return buf + off[r]; }
    int64_t n() const { return n_; }
    int32_t tid(int64_t r) const { return rd_i32(body(r)); }
    int64_t pos(int64_t r) const { return rd_i32(body(r) + 4); }
    uint16_t flag(int64_t r) const { return rd_u16(body(r) + 14); }
    uint8_t mapq(int64_t r) const { return body(r)[9]; }
    int32_t l_qseq(int64_t r) const { return rd_i32(body(r) + 16); }
    int64_t cig_n(int64_t r) const { return rd_u16(body(r) + 12); }
    uint32_t cig(int64_t r, int64_t k) const {
        const uint8_t* b = body(r);
        return rd_u32(b + 32 + b[8] + 4 * k);
    }
    struct SeqView {
        const uint8_t* sq;  // 4-bit packed, two bases per byte
        const uint8_t* qu;
        uint8_t base4(int64_t qp) const {
            uint8_t byte = sq[qp >> 1];
            return (qp & 1) ? (byte & 0xF) : (byte >> 4);
        }
        uint8_t qual(int64_t qp) const { return qu[qp]; }
    };
    SeqView seqview(int64_t r) const {
        const uint8_t* b = body(r);
        int64_t nc = rd_u16(b + 12);
        int32_t ls = rd_i32(b + 16);
        const uint8_t* sq = b + 32 + b[8] + 4 * nc;
        return {sq, sq + (ls + 1) / 2};
    }
};

template <class R>
static int64_t read_end(const R& rd, int64_t r) {
    int64_t end = rd.pos(r);
    for (int64_t k = 0, kn = rd.cig_n(r); k < kn; ++k) {
        uint32_t c = rd.cig(r, k);
        uint32_t op = c & 0xF;
        if (op == CMATCH || op == CDEL || op == CREF_SKIP) end += c >> 4;
    }
    return end;
}

// Pass 1 of pileup_build_tpl for a region load's records, all of one
// contig, as the card build takes them, in one pass over the records: the
// filter (flag mask with BAM_FUNMAP always, the mapQ floor), the
// sortedness check (false, with g_err set) and the carried
// contig-transition drop (the drop between contigs within a call has no
// second contig to act on).  ``rec`` gets the kept records' body offsets,
// ``max_end`` and ``max_len`` the furthest end and the longest extent of
// them on the reference.
static bool region_pass1(const BufReads& rd, int flag_mask, int mapq_thresh,
                         int64_t drop_first_end_le, std::vector<int64_t>& rec,
                         int64_t& max_end, int64_t& max_len) {
    const int fmask = flag_mask | 0x4;
    int64_t prev_pos = -1;
    bool first = true;
    for (int64_t r = 0; r < rd.n(); ++r) {
        const int64_t pos = rd.pos(r);
        if (pos < prev_pos) {
            g_err = "BAM is not coordinate-sorted";
            return false;
        }
        prev_pos = pos;
        if ((rd.flag(r) & fmask) != 0 || rd.mapq(r) < mapq_thresh) continue;
        const int64_t e = read_end(rd, r);
        if (first) {
            first = false;
            if (drop_first_end_le >= 0 && e <= drop_first_end_le) continue;
        }
        rec.push_back(rd.off[r]);
        max_end = std::max(max_end, e);
        max_len = std::max(max_len, e - pos);
    }
    return true;
}

template <class R>
static NativePileup* pileup_build_tpl(const R& nb, int flag_mask,
                                      int mapq_thresh, int64_t wbeg,
                                      int64_t wend,
                                      int64_t drop_first_end_le) {
    const int fmask = flag_mask | 0x4;  // BAM_FUNMAP always filtered
    auto* st = new PileupStorage();

    // pass 1: filtered read list + contig-transition drop quirk.
    // Coordinate-sortedness is enforced here because the counting build
    // below silently assumes it (the reference abort()s on unsorted
    // input, sniper_pileup.c:212).
    std::vector<int64_t> ridx;
    ridx.reserve(nb.n());
    int32_t prev_tid = -1;
    int64_t prev_pos = -1;
    for (int64_t r = 0; r < nb.n(); ++r) {
        int32_t t = nb.tid(r);
        if (t >= 0) {
            if (t < prev_tid ||
                (t == prev_tid && nb.pos(r) < prev_pos)) {
                g_err = "BAM is not coordinate-sorted";
                delete st;
                return nullptr;
            }
            prev_tid = t;
            prev_pos = nb.pos(r);
        }
        if ((nb.flag(r) & fmask) == 0 && nb.mapq(r) >= mapq_thresh)
            ridx.push_back(r);
    }
    // cross-shard quirk carry: a windowed (region-sharded) load of a
    // contig start replicates the transition drop below by passing the
    // previous contig's last kept-read start (see sniper_pileup.c:216)
    if (drop_first_end_le >= 0 && !ridx.empty() &&
        read_end(nb, ridx[0]) <= drop_first_end_le)
        ridx.erase(ridx.begin());

    // drop the first filter-passing read of each subsequent contig when
    // its end precedes the previous contig's last read start
    // (reference sniper_pileup.c:216)
    {
        std::vector<int64_t> kept;
        kept.reserve(ridx.size());
        for (size_t i = 0; i < ridx.size(); ++i) {
            if (i > 0 && nb.tid(ridx[i]) != nb.tid(ridx[i - 1]) &&
                read_end(nb, ridx[i]) <= nb.pos(ridx[i - 1]))
                continue;
            kept.push_back(ridx[i]);
        }
        ridx.swap(kept);
    }

    // pass 2+3: per-contig counting build.  Reads are coordinate-sorted,
    // so kept reads form contiguous tid segments.  Per segment:
    //   (a) difference-array coverage counts over [0, max_end) — O(runs),
    //       one ++/-- per M/D CIGAR run instead of one per base;
    //   (b) prefix-sum to per-position entry offsets, emitting
    //       ukeys/offsets for covered positions on the fly;
    //   (c) scatter the packed slot words through per-position cursors.
    // Replaces the previous sort(+unique) of all entries — O(entries)
    // instead of O(entries log entries), ~8x faster at 30x depth.
    // Within-column entry order becomes read-arrival order (the same
    // order the reference's linked-list pileup produces); the model is
    // order-independent within a column (see SURVEY glfgen analysis).
    // One up-front reservation of the slot store: entries == aligned
    // M/D bases, bounded by the kept reads' reference spans.  Without
    // it the per-segment resize re-copies the whole store when a later
    // contig grows it (measured ~3x build-phase cost on a 2-contig
    // whole-file load vs the windowed path).
    {
        int64_t est = 0;
        for (int64_t r : ridx) est += read_end(nb, r) - nb.pos(r);
        if (est > 0) st->slots.reserve((size_t)est);
    }
    std::vector<uint32_t> diff;  // coverage diff, then per-pos cursors
    size_t i0 = 0;
    while (i0 < ridx.size()) {
        size_t i1 = i0;
        const int32_t tid = nb.tid(ridx[i0]);
        int64_t max_end = 0;
        while (i1 < ridx.size() && nb.tid(ridx[i1]) == tid) {
            int64_t e = read_end(nb, ridx[i1]);
            if (e > max_end) max_end = e;
            ++i1;
        }
        // window clip: columns restricted to [wbeg, wend) — reads
        // overlapping the boundary contribute only their in-window
        // columns (halo handling for region sharding)
        const int64_t lo = wbeg > 0 ? wbeg : 0;
        const int64_t hi = wend >= 0 && wend < max_end ? wend : max_end;
        if (hi <= lo) {
            i0 = i1;
            continue;
        }
        const int64_t span = hi - lo;
        diff.assign((size_t)span + 1, 0u);

        // (a) coverage diffs per M/D run
        for (size_t k = i0; k < i1; ++k) {
            int64_t r = ridx[k];
            int64_t x = nb.pos(r);
            for (int64_t c = 0, cn = nb.cig_n(r); c < cn; ++c) {
                uint32_t cg = nb.cig(r, c);
                uint32_t op = cg & 0xF;
                int64_t l = cg >> 4;
                if (op == CMATCH || op == CDEL) {
                    int64_t a = x > lo ? x : lo;
                    int64_t b = x + l < hi ? x + l : hi;
                    if (b > a) {
                        ++diff[a - lo];
                        --diff[b - lo];
                    }
                    x += l;
                } else if (op == CREF_SKIP) {
                    x += l;
                }
            }
        }

        // (b) prefix sum -> per-position start offsets + column index
        const int64_t base = (int64_t)st->slots.size();
        st->ukeys.reserve(st->ukeys.size() + (size_t)span);
        st->offsets.reserve(st->offsets.size() + (size_t)span + 1);
        const int64_t key_hi = ((int64_t)tid) << 40;
        uint32_t depth = 0;
        uint32_t excl = 0;
        for (int64_t p = 0; p < span; ++p) {
            depth += diff[p];
            diff[p] = excl;  // repurpose as scatter cursor
            if (depth > 0) {
                st->ukeys.push_back(key_hi | (p + lo));
                st->offsets.push_back(base + excl);
                excl += depth;
            }
        }
        st->slots.resize((size_t)(base + excl));

        // (c) stable scatter of packed slots
        uint32_t* out = st->slots.data() + base;
        for (size_t k = i0; k < i1; ++k) {
            int64_t r = ridx[k];
            int64_t x = nb.pos(r);
            int64_t y = 0;
            const auto sv = nb.seqview(r);
            const int32_t lq = nb.l_qseq(r);
            const int64_t max_q = lq > 0 ? lq - 1 : 0;
            const uint32_t mq = nb.mapq(r);
            const uint32_t strand = (nb.flag(r) >> 4) & 1;
            const uint32_t bw = mq | (strand << 20);
            for (int64_t c = 0, cn = nb.cig_n(r); c < cn; ++c) {
                uint32_t cg = nb.cig(r, c);
                uint32_t op = cg & 0xF;
                int64_t l = cg >> 4;
                if (op == CMATCH) {
                    int64_t a = x > lo ? x : lo;
                    int64_t b = x + l < hi ? x + l : hi;
                    int64_t qp0 = y + (a - x);
                    uint32_t* dcur = diff.data() + (a - lo);
                    if (qp0 + (b - a) <= max_q + 1) {
                        // common case (well-formed CIGAR): no per-base
                        // qual clamp, hoisted base word, direct cursor
                        // pointer — this loop touches every aligned
                        // base of every read and sets the build rate
                        for (int64_t i = 0, n2 = b - a; i < n2; ++i) {
                            int64_t q2 = qp0 + i;
                            out[dcur[i]++] =
                                bw | ((uint32_t)sv.qual(q2) << 8) |
                                ((uint32_t)sv.base4(q2) << 16);
                        }
                    } else {
                        for (int64_t px = a; px < b; ++px) {
                            int64_t qp = y + (px - x);
                            if (qp > max_q) qp = max_q;
                            if (qp < 0) qp = 0;
                            out[diff[px - lo]++] =
                                bw | ((uint32_t)sv.qual(qp) << 8) |
                                ((uint32_t)sv.base4(qp) << 16);
                        }
                    }
                    x += l;
                    y += l;
                } else if (op == CDEL) {
                    int64_t a = x > lo ? x : lo;
                    int64_t b = x + l < hi ? x + l : hi;
                    for (int64_t px = a; px < b; ++px)
                        out[diff[px - lo]++] =
                            mq | (strand << 20) | (1u << 21);
                    x += l;
                } else if (op == CREF_SKIP) {
                    x += l;
                } else if (op == CINS || op == CSOFT) {
                    y += l;
                }
                // H/P/=/X ignored, exactly like samtools-0.1.6
            }
        }
        i0 = i1;
    }
    const int64_t n_entries = (int64_t)st->slots.size();
    st->offsets.push_back(n_entries);

    auto* np = new NativePileup();
    np->n_entries = n_entries;
    np->n_cols = (int64_t)st->ukeys.size();
    np->keys = nullptr;  // per-entry keys are implied by ukeys/offsets
    np->slots = st->slots.data();
    np->ukeys = st->ukeys.data();
    np->offsets = st->offsets.data();
    np->pure = nullptr;
    np->_storage = st;
    return np;
}

}  // namespace

extern "C" {

static inline bool column_pure_ref(const NativePileup* np, int64_t c,
                                   uint8_t rcode, const double* fk,
                                   const double* gmin, double margin);

// Compute per-column pure-reference margin flags into st->pure (fused
// into the load so the cost rides the per-file decode threads instead
// of the serial plan phase; same predicate as column_pure_ref).
static void fill_pure_flags(NativePileup* np, const uint8_t* ref16,
                            const int64_t* ref_off, int32_t n_ref,
                            const double* fk, const double* gmin,
                            double margin) {
    const int64_t POS_MASK = ((int64_t)1 << 40) - 1;
    auto* st = (PileupStorage*)np->_storage;
    st->pure.assign((size_t)np->n_cols, 0);
    for (int64_t c = 0; c < np->n_cols; ++c) {
        int64_t key = np->ukeys[c];
        int32_t tid = (int32_t)(key >> 40);
        int64_t pos = key & POS_MASK;
        if (tid < 0 || tid >= n_ref) continue;
        if (pos >= ref_off[tid + 1] - ref_off[tid]) continue;
        uint8_t rc = ref16[ref_off[tid] + pos];
        st->pure[(size_t)c] =
            column_pure_ref(np, c, rc, fk, gmin, margin) ? 1 : 0;
    }
    np->pure = st->pure.data();
}

// g++ contracts the flags' ``L += fk[m] * eff`` into one fused
// multiply-add where the target has one (its default -ffp-contract=fast;
// the library is built with -march=native): the card's chain does as
// this build's does.
#ifdef __FMA__
static const int kPureFused = 1;
#else
static const int kPureFused = 0;
#endif

// A region load's pileup (and flags, with ``ref16``) built by the card
// builder ``fn`` from the records of ``rd``, all of contig ``tid`` (the
// region's, as region_scan keeps them): pass 1 here, the rest on the card,
// the same bytes as pileup_build_tpl + fill_pure_flags.  nullptr with
// g_err set where pass 1 or the card failed; nullptr with ``*declined``
// where the host is to build it.
static NativePileup* card_pileup(CardPileupFn fn, CardReleaseFn release,
                                 const BufReads& rd, int32_t tid,
                                 int64_t n_bytes, int flag_mask,
                                 int mapq_thresh, int64_t wbeg, int64_t wend,
                                 int64_t drop_first_end_le,
                                 const uint8_t* ref16, const int64_t* ref_off,
                                 int32_t n_ref, const double* fk,
                                 const double* gmin, double margin,
                                 bool* declined) {
    std::vector<int64_t> rec;
    rec.reserve((size_t)rd.n());
    int64_t max_end = 0, max_len = 0;
    if (!region_pass1(rd, flag_mask, mapq_thresh, drop_first_end_le, rec,
                      max_end, max_len))
        return nullptr;
    if (rec.size() > (size_t)INT32_MAX) {
        *declined = true;
        return nullptr;
    }
    const int64_t lo = wbeg > 0 ? wbeg : 0;
    const int64_t hi = wend >= 0 && wend < max_end ? wend : max_end;
    // the reference codes from lo on; the positions past the contig's
    // reference (or of a contig the reference lacks) are never pure
    const uint8_t* ref = ref16;
    int64_t n_codes = 0;
    if (ref16 && tid >= 0 && tid < n_ref &&
        lo < ref_off[tid + 1] - ref_off[tid]) {
        ref = ref16 + ref_off[tid] + lo;
        n_codes = ref_off[tid + 1] - ref_off[tid] - lo;
    }
    void* out[5];
    long long counts[2];
    const int rc = fn(g_card_device.load(), rd.buf, (long long)n_bytes,
                      rec.data(), (int)rec.size(), tid, lo, hi, max_len, ref,
                      n_codes, fk, gmin, margin, kPureFused, out, counts);
    if (rc != 0) {
        if (rc < 0)
            *declined = true;
        else
            g_err = "pileup build failure (region, card: CUDA error " +
                    std::to_string(rc) + ")";
        return nullptr;
    }
    auto* st = new PileupStorage();
    st->card_buffer = out[0];
    st->card_release = release;
    auto* np = new NativePileup();
    np->n_cols = counts[0];
    np->n_entries = counts[1];
    np->keys = nullptr;
    np->ukeys = static_cast<int64_t*>(out[1]);
    np->offsets = static_cast<int64_t*>(out[2]);
    np->slots = static_cast<uint32_t*>(out[3]);
    np->pure = ref16 ? static_cast<uint8_t*>(out[4]) : nullptr;
    np->_storage = st;
    return np;
}

NativePileup* pileup_build(const NativeBam* nb, int flag_mask,
                           int mapq_thresh) {
    return pileup_build_tpl(ArrayReads{nb}, flag_mask, mapq_thresh, -1, -1,
                            -1);
}

// pileup_build + fused pure-reference flags (ref16/fk/gmin as in
// pileup_flags; pass ref16 = NULL to skip flag computation).
NativePileup* pileup_build_flagged(const NativeBam* nb, int flag_mask,
                                   int mapq_thresh, const uint8_t* ref16,
                                   const int64_t* ref_off, int32_t n_ref,
                                   const double* fk, const double* gmin,
                                   double margin) {
    NativePileup* np = pileup_build_tpl(ArrayReads{nb}, flag_mask,
                                        mapq_thresh, -1, -1, -1);
    if (np && ref16)
        fill_pure_flags(np, ref16, ref_off, n_ref, fk, gmin, margin);
    return np;
}

// Windowed build: columns clipped to [wbeg, wend) (wend < 0 = no limit).
// ``drop_first_end_le`` >= 0 applies the contig-transition drop quirk
// against that carried-in previous-contig read start.
NativePileup* pileup_build_window(const NativeBam* nb, int flag_mask,
                                  int mapq_thresh, int64_t wbeg,
                                  int64_t wend, int64_t drop_first_end_le) {
    return pileup_build_tpl(ArrayReads{nb}, flag_mask, mapq_thresh, wbeg,
                            wend, drop_first_end_le);
}

NativePileup* pileup_build_window_flagged(
    const NativeBam* nb, int flag_mask, int mapq_thresh, int64_t wbeg,
    int64_t wend, int64_t drop_first_end_le, const uint8_t* ref16,
    const int64_t* ref_off, int32_t n_ref, const double* fk,
    const double* gmin, double margin) {
    NativePileup* np = pileup_build_tpl(ArrayReads{nb}, flag_mask,
                                        mapq_thresh, wbeg, wend,
                                        drop_first_end_le);
    if (np && ref16)
        fill_pure_flags(np, ref16, ref_off, n_ref, fk, gmin, margin);
    return np;
}

// Fused whole-file load: BGZF inflate -> record-boundary scan -> pileup
// build directly off the record bytes (BufReads).  Skips materializing
// the columnar NativeBam arrays (per-base seq/qual unpack, cigar copy)
// entirely — the production load path only ever wants the pileup.
// ``ref16`` != NULL additionally computes the fused pure-reference
// margin flags (same tail arguments as pileup_build_flagged).
NativePileup* bam_load_pileup(const char* path, int n_threads,
                              int flag_mask, int mapq_thresh,
                              const uint8_t* ref16, const int64_t* ref_off,
                              int32_t n_ref, const double* fk,
                              const double* gmin, double margin) {
    try {
    std::vector<uint8_t> raw;
    {
        ProfSpan ps(0);
        if (!read_file(path, raw)) {
            g_err = std::string("cannot read ") + path;
            return nullptr;
        }
    }
    std::vector<uint8_t> buf;
    {
        ProfSpan ps(2);
        if (!bgzf_decompress(raw, buf, n_threads, g_err)) return nullptr;
    }
    raw.clear();
    raw.shrink_to_fit();
    int64_t p = parse_bam_header(buf.data(), (int64_t)buf.size(), nullptr);
    if (p < 0) {
        g_err = p == -1 ? "truncated BAM header"
                        : "not a BAM file (bad magic)";
        return nullptr;
    }
    const int64_t n = (int64_t)buf.size();
    std::vector<int64_t> off;
    off.reserve((size_t)((n - p) / 100) + 16);
    {
        ProfSpan ps(3);
        while (p + 4 <= n) {
            int32_t bs = rd_i32(&buf[p]);
            if (bs < 32 || p + 4 + bs > n ||
                !record_layout_ok(&buf[p + 4], bs)) {
                g_err = "truncated or corrupt BAM record";
                return nullptr;
            }
            off.push_back(p + 4);
            p += 4 + bs;
        }
        if (p != n) {
            g_err = "trailing bytes after last BAM record";
            return nullptr;
        }
    }
    BufReads rd{buf.data(), off.data(), (int64_t)off.size()};
    NativePileup* np;
    {
        ProfSpan ps(4);
        np = pileup_build_tpl(rd, flag_mask, mapq_thresh, -1, -1, -1);
    }
    if (np && ref16) {
        ProfSpan ps(5);
        fill_pure_flags(np, ref16, ref_off, n_ref, fk, gmin, margin);
    }
    return np;
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

NativePileup* bam_load_region_pileup(
    const char* path, const int64_t* chunks, int64_t n_chunks,
    int32_t tid, int64_t beg, int64_t end, int n_threads, int flag_mask,
    int mapq_thresh, int64_t drop_first_end_le, const uint8_t* ref16,
    const int64_t* ref_off, int32_t n_ref, const double* fk,
    const double* gmin, double margin) {
    try {
    std::vector<uint8_t> all;
    std::vector<int64_t> kept;
    if (!region_scan(path, chunks, n_chunks, tid, beg, end, n_threads,
                     all, kept, g_err))
        return nullptr;
    const int64_t refused = t_region_refused;
    BufReads rd{all.data(), kept.data(), (int64_t)kept.size()};
    NativePileup* np;
    // with a card builder registered the card builds the pileup and its
    // flags, unless the card refused one of the region's blocks; its wait
    // counts as the pileup build
    if (CardPileupFn card = g_card_pileup.load(); card && refused == 0) {
        ProfSpan ps(4);
        bool declined = false;
        np = card_pileup(card, g_card_release.load(), rd, tid,
                         (int64_t)all.size(), flag_mask,
                         mapq_thresh, beg, end, drop_first_end_le, ref16,
                         ref_off, n_ref, fk, gmin, margin, &declined);
        if (!declined) {
            if (np) g_regions[0].fetch_add(1);
            return np;
        }
    }
    {
        ProfSpan ps(4);
        np = pileup_build_tpl(rd, flag_mask, mapq_thresh, beg, end,
                              drop_first_end_le);
    }
    if (np && ref16) {
        ProfSpan ps(5);
        fill_pure_flags(np, ref16, ref_off, n_ref, fk, gmin, margin);
    }
    if (np) g_regions[1].fetch_add(1);
    return np;
    } catch (const std::exception& e) {
        g_err = std::string("native load failed: ") + e.what();
        return nullptr;
    }
}

// The load counters since the library was loaded, read without reset:
// seconds[6] <- {read, bgzf_scan, inflate, record_scan, pileup_build,
// pure_flags}, summed over threads; counts[7] <- {bytes_inflated,
// blocks_libdeflate, blocks_zlib, blocks_card, blocks_card_redo,
// regions_card_built, regions_host_built}.
void sniper_load_counters(double* seconds, int64_t* counts) {
    for (int i = 0; i < 6; ++i)
        seconds[i] = (double)g_prof[i].load() * 1e-9;
    for (int i = 0; i < 5; ++i) counts[i] = g_inflate[i].load();
    for (int i = 0; i < 2; ++i) counts[5 + i] = g_regions[i].load();
}

// Register the card inflater the region loads hand their BGZF blocks to
// (a CardInflateFn, called with ``device``), or, with NULL, none: every
// block is then inflated on the host.  The whole-file load never uses it.
void sniper_set_card_inflate(void* fn, int device) {
    g_card_device.store(device);
    g_card_inflate.store(reinterpret_cast<CardInflateFn>(fn));
}

// Register the card builder the region loads hand their pileup builds to
// (a CardPileupFn, called with sniper_set_card_inflate's device, and the
// CardReleaseFn its pileups' buffers go back to), or, with NULL, none:
// every region's pileup is then built on the host.  The whole-file load
// never uses it.
void sniper_set_card_pileup(void* fn, void* release) {
    g_card_release.store(reinterpret_cast<CardReleaseFn>(release));
    g_card_pileup.store(reinterpret_cast<CardPileupFn>(fn));
}

void pileup_destroy(NativePileup* np) {
    if (!np) return;
    delete (PileupStorage*)np->_storage;
    delete np;
}

// Per-column pure-reference prefilter statistics.
//
// A column is marked filterable (out[c] = 1) when it provably cannot be
// emitted by the caller: every non-deleted entry carries the reference
// base (or '=', code 0), the reference code is unambiguous ACGT, at least
// one entry contributes to the genotype counts, and a rearrangement-
// inequality lower bound L on the reference-class esum clears the margin
//
//     L + gmin[min(m, 255)] >= margin
//
// where gmin[m] = min_q coef[q, m, m] (the only coef entries a pure
// column's non-reference genotypes can touch) is precomputed by the
// caller.  Under that bound every non-reference genotype's quantized
// likelihood is >= 1 while hom-ref is exactly 0, so both samples call the
// hom-ref genotype and the SNP gate (tumor_gt != normal_gt,
// reference somatic_sniper.c:156) can never pass.  Columns that fail the
// bound (junk-quality pileups) simply stay unfiltered — correctness never
// depends on this filter, only throughput does.
//
// L accumulates fk[r] * effq in entry-arrival order with a single rank
// counter shared across strands; the true esum uses per-(base,strand)
// rank counters and descending-quality order (reference
// sniper_maqcns.c:162-175), both of which only raise the fk weights, so
// L is a valid lower bound.
void pileup_flags(const NativePileup* np, const uint8_t* ref16,
                  const int64_t* ref_off, int32_t n_ref, const double* fk,
                  const double* gmin, double margin, uint8_t* out) {
    const int64_t POS_MASK = ((int64_t)1 << 40) - 1;
    for (int64_t c = 0; c < np->n_cols; ++c) {
        out[c] = 0;
        int64_t key = np->ukeys[c];
        int32_t tid = (int32_t)(key >> 40);
        int64_t pos = key & POS_MASK;
        if (tid < 0 || tid >= n_ref) continue;
        if (pos >= ref_off[tid + 1] - ref_off[tid]) continue;
        uint8_t rcode = ref16[ref_off[tid] + pos];
        if (rcode != 1 && rcode != 2 && rcode != 4 && rcode != 8) continue;
        bool pure = true;
        int64_t m = 0;
        double L = 0.0;
        for (int64_t i = np->offsets[c]; i < np->offsets[c + 1]; ++i) {
            uint32_t s = np->slots[i];
            if ((s >> 21) & 1) continue;  // deletions never reach glfgen
            uint32_t b16 = (s >> 16) & 0xF;
            if (b16 != rcode && b16 != 0) {
                pure = false;
                break;
            }
            uint32_t q = (s >> 8) & 0xFF;
            uint32_t mq = s & 0xFF;
            uint32_t eff = q < mq ? q : mq;
            if (eff < 4 && (q & 0x3F) != 0) eff = 4;
            if (eff > 0) {
                L += fk[m < 255 ? m : 255] * (double)eff;
                ++m;
            }
        }
        if (pure && m >= 1 && L + gmin[m <= 255 ? m : 254] >= margin)
            out[c] = 1;
    }
}

// Max start position of filter-passing reads in the given region, or -1
// (-2 on IO error).  The sharded driver uses it to carry the
// contig-transition drop quirk (reference sniper_pileup.c:216) across
// shard boundaries: the first kept read of a contig is dropped when its
// end precedes the previous contig's last kept-read start.
int64_t region_last_kept_start(const char* path, const int64_t* chunks,
                               int64_t n_chunks, int32_t tid, int64_t beg,
                               int64_t end, int flag_mask, int mapq_thresh,
                               int n_threads) {
    std::vector<uint8_t> all;
    std::vector<int64_t> kept;
    if (!region_scan(path, chunks, n_chunks, tid, beg, end, n_threads,
                     all, kept, g_err))
        return -2;
    const int fmask = flag_mask | 0x4;
    int64_t last = -1;
    for (int64_t off : kept) {
        const uint8_t* r = &all[off];
        if ((rd_u16(r + 14) & fmask) == 0 && r[9] >= mapq_thresh) {
            int64_t pos = rd_i32(r + 4);
            if (pos > last) last = pos;
        }
    }
    return last;
}

// Dense padding: scatter selected columns' slots into a [B, D] array
// (row-major, caller-allocated, zero-filled by callee).
void pileup_pad(const NativePileup* np, const int64_t* col_idx, int64_t B,
                int64_t D, uint32_t* out) {
    memset(out, 0, sizeof(uint32_t) * B * D);
    for (int64_t b = 0; b < B; ++b) {
        int64_t ci = col_idx[b];
        int64_t s = np->offsets[ci];
        int64_t n = np->offsets[ci + 1] - s;
        if (n > D) n = D;
        for (int64_t i = 0; i < n; ++i) out[b * D + i] = np->slots[s + i];
    }
}

// Compact 16-bit padding for the device fast path.
//
// The f32 likelihood kernel only needs each non-deleted read's
// (base2, strand, floored effQ): reads of equal class and effQ are
// interchangeable under the MAQ rank weighting (same fk·effQ terms in
// any order), so baseQ/mapQ tie-break bits carry no information, and
// the per-column RMS-mapQ sum and non-deleted count are scalars this
// pass computes host-side.  Halves host->device bytes vs the u32 slots.
//
// out16 entry: effq | base2<<8 | strand<<10  (base2 = 0 when the base
// is ambiguous — such reads join class A exactly like the reference's
// unset aux base bits, sniper_maqcns.c:144-156).  ref16 supplies the
// '=' resolution per column.
void pileup_pad16(const NativePileup* np, const int64_t* col_idx,
                  const int32_t* ref16, int64_t B, int64_t D,
                  int32_t cap_mapq, uint16_t* out16, int32_t* out_nkeep,
                  int32_t* out_rms) {
    memset(out16, 0, sizeof(uint16_t) * B * D);
    for (int64_t b = 0; b < B; ++b) {
        int64_t ci = col_idx[b];
        int64_t s = np->offsets[ci];
        int64_t e = np->offsets[ci + 1];
        int64_t k = 0;
        int64_t rms = 0;
        for (int64_t i = s; i < e; ++i) {
            uint32_t w = np->slots[i];
            if ((w >> 21) & 1) continue;  // deletion
            uint32_t mq = w & 0xFF;
            uint32_t q = (w >> 8) & 0xFF;
            uint32_t b16 = (w >> 16) & 0xF;
            uint32_t strand = (w >> 20) & 1;
            uint32_t code = b16 ? b16 : (uint32_t)ref16[b];
            uint32_t base2;
            switch (code) {
                case 1: base2 = 0; break;
                case 2: base2 = 1; break;
                case 4: base2 = 2; break;
                case 8: base2 = 3; break;
                default: base2 = 0; break;  // ambiguous -> class A
            }
            uint32_t eff = q < mq ? q : mq;
            if (eff < 4 && (q & 0x3F) != 0) eff = 4;
            if (k < D)
                out16[b * D + k] =
                    (uint16_t)(eff | (base2 << 8) | (strand << 10));
            ++k;
            int32_t m7 = (int32_t)(mq & 0x7F);
            if (m7 > cap_mapq) m7 = cap_mapq;
            rms += (int64_t)m7 * m7;
        }
        out_nkeep[b] = (int32_t)k;
        out_rms[b] = (int32_t)rms;
    }
}

// One column's compact u16 padding (pileup_pad16 semantics, factored
// for the fused dual-sample slab fill below).
static inline void pad16_one(const NativePileup* np, int64_t ci,
                             int32_t rcode, int64_t D, int32_t cap_mapq,
                             uint16_t* row, int32_t* nk, int32_t* rms) {
    int64_t s = np->offsets[ci], e = np->offsets[ci + 1];
    int64_t k = 0;
    int64_t rm = 0;
    for (int64_t i = s; i < e; ++i) {
        uint32_t w = np->slots[i];
        if ((w >> 21) & 1) continue;  // deletion
        uint32_t mq = w & 0xFF;
        uint32_t q = (w >> 8) & 0xFF;
        uint32_t b16 = (w >> 16) & 0xF;
        uint32_t strand = (w >> 20) & 1;
        uint32_t code = b16 ? b16 : (uint32_t)rcode;
        uint32_t base2;
        switch (code) {
            case 1: base2 = 0; break;
            case 2: base2 = 1; break;
            case 4: base2 = 2; break;
            case 8: base2 = 3; break;
            default: base2 = 0; break;  // ambiguous -> class A
        }
        uint32_t eff = q < mq ? q : mq;
        if (eff < 4 && (q & 0x3F) != 0) eff = 4;
        if (k < D)
            row[k] = (uint16_t)(eff | (base2 << 8) | (strand << 10));
        ++k;
        int32_t m7 = (int32_t)(mq & 0x7F);
        if (m7 > cap_mapq) m7 = cap_mapq;
        rm += (int64_t)m7 * m7;
    }
    *nk = (int32_t)k;
    *rms = (int32_t)rm;
}

// One column's raw kept-only lane copy (round-5 slab encoding): lanes
// are the pileup slot words themselves with deletion entries dropped —
// the device derives eff-quality/classes/rms and the dqstats fields
// from the raw bits (models/somatic.py _device_dqstats), so the fill
// is a pure filtered copy with no per-read arithmetic.
static inline void raw_lanes_one(const NativePileup* np, int64_t ci,
                                 int64_t D, uint32_t* row, int32_t* nk) {
    int64_t s = np->offsets[ci], e = np->offsets[ci + 1];
    int64_t k = 0;
    for (int64_t i = s; i < e; ++i) {
        uint32_t w = np->slots[i];
        if ((w >> 21) & 1) continue;  // deletion
        if (k < D) row[k] = w & 0x1FFFFF;
        ++k;
    }
    // zero only the unwritten tail: the caller's slab buffers start
    // calloc'd, so a full-row memset would double the write traffic
    // (the fill is memory-bound — pure filtered copy, no arithmetic)
    int64_t kw = k < D ? k : D;
    if (kw < D)
        memset(row + kw, 0, sizeof(uint32_t) * (size_t)(D - kw));
    *nk = (int32_t)k;
}

// Fused dual-sample slab fill for the uniform-slab dispatcher
// (parallel/slab.py): copies tumor AND normal columns' kept slot words
// into the u32 lane stack and assembles the bit-packed device metadata
// (models/somatic.py call_batch_packed raw32 layout: meta0 carries only
// the reference code; rms moved on-device) in one internally-threaded
// pass.
// Depths and kept counts take bytes of meta2 to D = 255; a deeper slab
// takes the wide layout, 16-bit halves of meta1 (d_t | d_n << 16) and of
// meta2 (nk_t | nk_n << 16), its values at most D <= 65535.
void slab_fill_pair(const NativePileup* t, const NativePileup* n,
                    const int64_t* ti, const int64_t* ni,
                    const int32_t* ref16, const int32_t* d_t,
                    const int32_t* d_n, int64_t B, int64_t D,
                    int32_t cap_mapq, uint32_t* out_t, uint32_t* out_n,
                    int32_t* meta0, int32_t* meta1, int32_t* meta2) {
    (void)cap_mapq;  // rms is computed on-device from the raw lanes
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
            int32_t nk_t, nk_n;
            raw_lanes_one(t, ti[b], D, out_t + b * D, &nk_t);
            raw_lanes_one(n, ni[b], D, out_n + b * D, &nk_n);
            meta0[b] = (int32_t)((uint32_t)ref16[b] << 24);
            meta1[b] = 0;
            meta2[b] = (int32_t)((uint32_t)d_t[b] |
                                 ((uint32_t)d_n[b] << 8) |
                                 ((uint32_t)nk_t << 16) |
                                 ((uint32_t)nk_n << 24));
            if (D > 255) {
                meta1[b] = (int32_t)((uint32_t)d_t[b] |
                                     ((uint32_t)d_n[b] << 16));
                meta2[b] = (int32_t)((uint32_t)nk_t |
                                     ((uint32_t)nk_n << 16));
            }
        }
    };
    // Fill threading (SNIPER_FILL_THREADS overrides): since the raw-
    // lane rewrite the fill is a cheap filtered copy, and on <=2-core
    // hosts its 2-way burst preempts the BAM loader threads (the
    // pipeline's critical path) for less than it saves — the calling
    // (main) thread has idle load-wait time to spend anyway.  Hosts
    // with spare cores still split.
    static int nt = [] {
        const char* e = getenv("SNIPER_FILL_THREADS");
        if (e) {
            int v = atoi(e);
            if (v >= 1) return v > 2 ? 2 : v;
        }
        int hw = (int)std::thread::hardware_concurrency();
        return hw > 2 ? 2 : 1;
    }();
    if (nt > 1 && B > 2048) {
        int64_t mid = B / 2;
        std::thread th(work, 0, mid);
        work(mid, B);
        th.join();
    } else {
        work(0, B);
    }
}

// One column's pure-reference prefilter predicate (same condition as
// pileup_flags above; see pileup/prefilter.py for the safety argument).
static inline bool column_pure_ref(const NativePileup* np, int64_t c,
                                   uint8_t rcode, const double* fk,
                                   const double* gmin, double margin) {
    if (rcode != 1 && rcode != 2 && rcode != 4 && rcode != 8) return false;
    int64_t m = 0;
    double L = 0.0;
    for (int64_t i = np->offsets[c]; i < np->offsets[c + 1]; ++i) {
        uint32_t s = np->slots[i];
        if ((s >> 21) & 1) continue;  // deletion
        uint32_t b16 = (s >> 16) & 0xF;
        if (b16 != rcode && b16 != 0) return false;
        uint32_t q = (s >> 8) & 0xFF;
        uint32_t mq = s & 0xFF;
        uint32_t eff = q < mq ? q : mq;
        if (eff < 4 && (q & 0x3F) != 0) eff = 4;
        if (eff > 0) {
            L += fk[m < 255 ? m : 255] * (double)eff;
            ++m;
        }
    }
    return m >= 1 && L + gmin[m <= 255 ? m : 254] >= margin;
}

// ---- exact per-column consensus (host-side SNP-gate filter) ----------
//
// Replicates the exact-precision genotype path of models/glfgen.py +
// models/consensus.py (itself the oracle-validated replication of the
// MAQ model, reference sniper_maqcns.c:127-273) for ONE purpose: decide,
// with the reference's own double-precision arithmetic, each sample's
// best genotype so the caller's SNP gate (reference somatic_sniper.c:156
// — consensus calls must differ) can be evaluated before any device
// upload.  ~95% of impure shared columns at 30x have both samples
// calling hom-ref; filtering them host-side shrinks device uploads,
// kernel batches and result transfers by the same factor.
//
// Exactness notes (must mirror glfgen.py's exact path bit for bit):
//  * f32 esum/fsum accumulators updated through f64 ops (C semantics)
//  * per-(base,strand) rank counters, descending packed-key visit order
//  * effective-quality floor of 4 when the low six baseQ bits are set
//  * f32 left-to-right "others" sums, f32 ratio division, f64 +0.5 trunc
//  * table indices clamped at 255 (mirrors XLA's clamping gather)
//  * the "fix p[k,k]" best-base adjustment with strict-compare scans
//  * quantization to u8 with (int)(x + 0.5) truncation
//  * glf2cns het penalty q_r on non-homozygous slots, first-minimum wins

static const int32_t kGlfBase[10] = {1, 3, 5, 9, 2, 6, 10, 4, 12, 8};
static const int32_t kHetPen[10] = {0, 1, 1, 1, 0, 1, 1, 0, 1, 0};

struct GlfTables {
    const double* coef;  // [64*256*256] error-dependency coefficients
    const double* lhet;  // [256*256] het log-likelihood table
    const double* fk;    // [256] rank-decay weights
    int32_t q_r_int;     // het penalty of glf2cns
};

// Best genotype (4-bit allele set) of one pileup column; *out_keep gets
// the non-deleted entry count (the caller's glf-depth gate).
// Exact (f64, bit-identical to the reference) per-column glfgen: fills
// the quantized 10-genotype likelihoods and the kept-entry count.
static void glf_exact_lk(const NativePileup* np, int64_t c, int32_t rc,
                         const GlfTables& gt, int32_t lk[10],
                         int32_t* out_keep) {
    int64_t s0 = np->offsets[c], e0 = np->offsets[c + 1];
    thread_local std::vector<uint32_t> keys;
    keys.clear();
    for (int64_t i = s0; i < e0; ++i) {
        uint32_t w = np->slots[i];
        if ((w >> 21) & 1) continue;  // deletions never reach glfgen
        uint32_t mq = w & 0xFF;
        uint32_t q = (w >> 8) & 0xFF;
        uint32_t b16 = (w >> 16) & 0xF;
        uint32_t strand = (w >> 20) & 1;
        uint32_t eff = q < mq ? q : mq;
        uint32_t code = b16 ? b16 : (uint32_t)rc;
        uint32_t base2 = 4;
        switch (code) {
            case 1: base2 = 0; break;
            case 2: base2 = 1; break;
            case 4: base2 = 2; break;
            case 8: base2 = 3; break;
            default: break;  // ambiguous: no valid bit, no base bits
        }
        uint32_t x = (eff << 24) | (strand << 18) | (q << 8) | mq;
        if (base2 < 4) x |= (1u << 21) | (base2 << 16);
        keys.push_back(x);
    }
    int32_t n = (int32_t)keys.size();
    *out_keep = n;
    if (n == 0) {
        for (int i = 0; i < 10; ++i) lk[i] = 0;
    } else {
        std::sort(keys.begin(), keys.end());
        float esum[4] = {0, 0, 0, 0}, fsum[4] = {0, 0, 0, 0};
        int32_t cnt[4] = {0, 0, 0, 0};
        int32_t w8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int32_t i = n - 1; i >= 0; --i) {  // descending key order
            uint32_t info = keys[(size_t)i];
            int32_t effq = (int32_t)(info >> 24);
            int32_t low6 = (int32_t)((info >> 8) & 0x3F);
            if (effq < 4 && low6 != 0) effq = 4;
            int32_t k8 = (int32_t)((info >> 16) & 7);
            int32_t k4 = k8 & 3;
            if (effq > 0) {
                int32_t wk = w8[k8];
                double fkw = gt.fk[wk < 255 ? wk : 255];
                esum[k4] = (float)((double)esum[k4] + fkw * (double)effq);
                fsum[k4] = (float)((double)fsum[k4] + fkw);
                cnt[k4] += 1;
                if (w8[k8] < 255) w8[k8] += 1;
            }
        }
        int32_t c_tot = cnt[0] + cnt[1] + cnt[2] + cnt[3];
        if (c_tot > 255) {  // depth rescale (reference sniper_maqcns.c:178)
            int32_t nc[4];
            for (int j = 0; j < 4; ++j)
                nc[j] = (int32_t)std::floor(
                    254.0 * (double)cnt[j] / (double)c_tot + 0.5);
            c_tot = 0;
            for (int j = 0; j < 4; ++j) {
                cnt[j] = nc[j];
                c_tot += nc[j];
            }
        }
        int32_t n_idx = c_tot < 255 ? c_tot : 255;
        auto coef_at = [&](int32_t be, int32_t k) {
            int32_t k_idx = k < 255 ? k : 255;
            return gt.coef[((int64_t)be << 16) | ((int64_t)n_idx << 8) |
                           (int64_t)k_idx];
        };
        auto bar_e = [](float t1, float t3, int32_t t2) {
            float denom = (t3 == 0.0f) ? 1.0f : t3;
            float ratio = (t2 > 0) ? t1 / denom : 0.0f;
            int32_t be = (int32_t)std::floor((double)ratio + 0.5);
            if (be < 4) be = 4;
            if (be > 63) be = 63;
            return be;
        };
        float p[4][4];
        for (int j = 0; j < 4; ++j) {
            float t1 = 0.0f, t3 = 0.0f;
            int32_t t2 = 0;
            for (int k = 0; k < 4; ++k)
                if (k != j) {
                    t1 += esum[k];
                    t3 += fsum[k];
                    t2 += cnt[k];
                }
            p[j][j] = (t2 > 0)
                          ? (float)((double)t1 + coef_at(bar_e(t1, t3, t2), t2))
                          : 0.0f;
            for (int k = j + 1; k < 4; ++k) {
                float u1 = 0.0f, u3 = 0.0f;
                int32_t u2 = 0;
                for (int m = 0; m < 4; ++m)
                    if (m != j && m != k) {
                        u1 += esum[m];
                        u3 += fsum[m];
                        u2 += cnt[m];
                    }
                int32_t cj = cnt[j] < 255 ? cnt[j] : 255;
                int32_t ck = cnt[k] < 255 ? cnt[k] : 255;
                double lh = -4.343 * gt.lhet[(int64_t)cj * 256 + ck];
                float het =
                    (u2 > 0)
                        ? (float)((lh + (double)u1) +
                                  coef_at(bar_e(u1, u3, u2), u2))
                        : (float)lh;
                p[j][k] = het;
                p[k][j] = het;
            }
        }
        for (int j = 0; j < 4; ++j)
            for (int k = 0; k < 4; ++k)
                if (p[j][k] < 0.0f) p[j][k] = 0.0f;
        // "fix p[k,k]" best-base adjustment (reference :216-233)
        float max1 = -1.0f, max2 = -1.0f;
        int mk = -1;
        for (int k = 0; k < 4; ++k) {
            float e = esum[k];
            if (e > max1) {
                max2 = max1;
                max1 = e;
                mk = k;
            } else if (e > max2) {
                max2 = e;
            }
        }
        float min1 = 1e30f, min2 = 1e30f;
        int mnk = -1;
        for (int k = 0; k < 4; ++k) {
            float d = p[k][k];
            if (d < min1) {
                min2 = min1;
                min1 = d;
                mnk = k;
            } else if (d < min2) {
                min2 = d;
            }
        }
        bool fix =
            (max1 > max2) && (mnk != mk || (double)min1 + 1.0 > (double)min2);
        if (fix)
            p[mk][mk] =
                ((double)min1 > 1.0) ? (float)((double)min1 - 1.0) : 0.0f;
        // quantize to u8 likelihoods in upper-triangular order
        float p10[10];
        int idx = 0;
        for (int j = 0; j < 4; ++j)
            for (int k = j; k < 4; ++k) p10[idx++] = p[j][k];
        float minp = p10[0];
        for (int i = 1; i < 10; ++i)
            if (p10[i] < minp) minp = p10[i];
        for (int i = 0; i < 10; ++i) {
            float dl = p10[i] - minp;
            lk[i] = ((double)dl > 255.0)
                        ? 255
                        : (int32_t)std::floor((double)dl + 0.5);
        }
    }
}

static int32_t glf_exact_cns(const NativePileup* np, int64_t c, int32_t rc,
                             const GlfTables& gt, int32_t* out_keep) {
    int32_t lk[10];
    glf_exact_lk(np, c, rc, gt, lk, out_keep);
    // glf2cns: het penalty, first minimum wins (reference :250-273)
    int best = 0;
    int32_t bestv = lk[0] + kHetPen[0] * gt.q_r_int;
    for (int i = 1; i < 10; ++i) {
        int32_t t = lk[i] + kHetPen[i] * gt.q_r_int;
        if (t < bestv) {
            bestv = t;
            best = i;
        }
    }
    return kGlfBase[best];
}

// ---- near-pure consensus shortcut (tier 2a) -------------------------------
//
// For the ~20% of shared columns that fail the pure-reference margin
// test, the dominant case is a handful of sequencing-error reads on an
// otherwise reference-only pileup.  Proving that the exact model calls
// hom-ref for such a column needs far less work than evaluating all 10
// genotypes: p[r][r] depends only on the non-reference entries (exact,
// bit-identical arithmetic on <= 8 entries), and every other genotype
// admits a cheap sound lower bound:
//   * genotypes without r pay the full reference-class esum, lower-
//     bounded via Chebyshev's sum inequality (fk is decreasing, effq
//     descending by rank: sum fk[i]*e_(i) >= mean(fk)*sum(e) per class);
//   * hets r/x pay the het log-likelihood term -4.343*lhet[c_r][c_x]
//     (an exact lookup, since the counts are known);
//   * the coef correction is bounded below by a per-(n,k) minimum over
//     the 60 possible mean-quality rows (precomputed once per table).
// When every competing genotype's bound clears p[r][r] by >= 1.5 (one
// quantization unit plus float-rounding slack) and the reference class
// provably owns the "fix p[k,k]" adjustment, the quantized lk of every
// non-hom-ref genotype is >= 1 while hom-ref is 0 with zero het
// penalty, so sniper_glf2cns (first-minimum scan) must return r.
// Inconclusive columns (true variants, junk piles, depth > 255) fall
// back to glf_exact_cns — output never changes, only the filter cost.

static const double* shortcut_coefmin(const double* coef) {
    // min over the reachable mean-quality rows (bar_e clips to [4,63]),
    // clamped to <= 0 so it can be added as a pessimistic correction
    static std::mutex mu;
    static const double* key = nullptr;
    static std::vector<double> cm;
    std::lock_guard<std::mutex> g(mu);
    if (key != coef) {
        cm.assign(256 * 256, 0.0);
        for (int nn = 0; nn < 256; ++nn)
            for (int kk = 0; kk < 256; ++kk) {
                double mn = 0.0;
                for (int q = 4; q <= 63; ++q) {
                    double v = coef[((int64_t)q << 16) |
                                    ((int64_t)nn << 8) | kk];
                    if (v < mn) mn = v;
                }
                cm[(size_t)nn * 256 + kk] = mn;
            }
        key = coef;
    }
    return cm.data();
}

static const double* shortcut_fkpre(const double* fk) {
    static std::mutex mu;
    static const double* key = nullptr;
    static std::vector<double> pre;
    std::lock_guard<std::mutex> g(mu);
    if (key != fk) {
        pre.assign(257, 0.0);
        for (int i = 0; i < 256; ++i) pre[i + 1] = pre[i] + fk[i];
        key = fk;
    }
    return pre.data();
}

// Returns 1 (and sets *out_keep to the non-deleted entry count) when
// the column's exact consensus is proven to be hom-ref rc; 0 when
// inconclusive.  rc must be an unambiguous ACGT code.
static int glf_cns_homref_proof(const NativePileup* np, int64_t c,
                                int32_t rc, const GlfTables& gt,
                                const double* fkpre, const double* coefmin,
                                int32_t* out_keep) {
    int32_t rb2;
    switch (rc) {
        case 1: rb2 = 0; break;
        case 2: rb2 = 1; break;
        case 4: rb2 = 2; break;
        case 8: rb2 = 3; break;
        default: return 0;
    }
    const int64_t s0 = np->offsets[c], e0 = np->offsets[c + 1];
    int32_t n_all = 0;
    int64_t rcnt[2] = {0, 0}, rsum[2] = {0, 0};
    uint32_t nr[8];
    int m = 0;
    for (int64_t i = s0; i < e0; ++i) {
        uint32_t w = np->slots[i];
        if ((w >> 21) & 1) continue;
        ++n_all;
        uint32_t mq = w & 0xFF;
        uint32_t q = (w >> 8) & 0xFF;
        uint32_t b16 = (w >> 16) & 0xF;
        uint32_t strand = (w >> 20) & 1;
        uint32_t eff = q < mq ? q : mq;
        uint32_t code = b16 ? b16 : (uint32_t)rc;
        uint32_t base2 = 4;
        switch (code) {
            case 1: base2 = 0; break;
            case 2: base2 = 1; break;
            case 4: base2 = 2; break;
            case 8: base2 = 3; break;
            default: break;
        }
        // same packing as glf_exact_cns so ranks/ties replicate
        uint32_t x = (eff << 24) | (strand << 18) | (q << 8) | mq;
        if (base2 < 4) x |= (1u << 21) | (base2 << 16);
        int32_t effq = (int32_t)eff;
        if (effq < 4 && (q & 0x3F) != 0) effq = 4;
        if (effq == 0) continue;  // inactive entries never accumulate
        int32_t k8 = (int32_t)((x >> 16) & 7);
        if ((k8 & 3) == rb2) {
            rcnt[k8 >> 2] += 1;
            rsum[k8 >> 2] += effq;
        } else {
            if (m == 8) return 0;  // too impure for the cheap proof
            nr[m++] = x;
        }
    }
    const int64_t c_r = rcnt[0] + rcnt[1];
    // exact non-ref accumulation, identical order/arithmetic to
    // glf_exact_cns (descending packed keys, per-(base,strand) ranks,
    // float esum updated through double products)
    for (int a = 1; a < m; ++a) {  // insertion sort descending
        uint32_t v = nr[a];
        int b = a - 1;
        while (b >= 0 && nr[b] < v) {
            nr[b + 1] = nr[b];
            --b;
        }
        nr[b + 1] = v;
    }
    float esum[4] = {0, 0, 0, 0}, fsum[4] = {0, 0, 0, 0};
    int32_t cnt[4] = {0, 0, 0, 0};
    int32_t w8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < m; ++i) {
        uint32_t info = nr[i];
        int32_t effq = (int32_t)(info >> 24);
        int32_t low6 = (int32_t)((info >> 8) & 0x3F);
        if (effq < 4 && low6 != 0) effq = 4;
        int32_t k8 = (int32_t)((info >> 16) & 7);
        int32_t k4 = k8 & 3;
        int32_t wk = w8[k8];
        double fkw = gt.fk[wk < 255 ? wk : 255];
        esum[k4] = (float)((double)esum[k4] + fkw * (double)effq);
        fsum[k4] = (float)((double)fsum[k4] + fkw);
        cnt[k4] += 1;
        if (w8[k8] < 255) w8[k8] += 1;
    }
    cnt[rb2] = (int32_t)(c_r < 255 ? c_r : 255);
    int64_t c_tot64 = c_r;
    for (int k = 0; k < 4; ++k)
        if (k != rb2) c_tot64 += cnt[k];
    if (c_tot64 == 0 || c_tot64 > 255) return 0;  // rescale path: bail
    const int32_t c_tot = (int32_t)c_tot64;
    const int32_t n_idx = c_tot;

    // exact p[r][r] (bit-identical to the full evaluation)
    float t1 = 0.0f, t3 = 0.0f;
    int32_t t2 = 0;
    for (int k = 0; k < 4; ++k)
        if (k != rb2) {
            t1 += esum[k];
            t3 += fsum[k];
            t2 += cnt[k];
        }
    float p_rr = 0.0f;
    if (t2 > 0) {
        float denom = (t3 == 0.0f) ? 1.0f : t3;
        float ratio = t1 / denom;
        int32_t be = (int32_t)std::floor((double)ratio + 0.5);
        if (be < 4) be = 4;
        if (be > 63) be = 63;
        int32_t k_idx = t2 < 255 ? t2 : 255;
        p_rr = (float)((double)t1 +
                       gt.coef[((int64_t)be << 16) |
                               ((int64_t)n_idx << 8) | k_idx]);
    }
    if (p_rr < 0.0f) p_rr = 0.0f;

    // Chebyshev lower bound on the reference-class esum (per strand
    // class; 0.5 absorbs the float accumulation error of the real sum)
    double es_lb = 0.0;
    for (int st = 0; st < 2; ++st)
        if (rcnt[st] > 0) {
            int64_t cc = rcnt[st] < 256 ? rcnt[st] : 256;
            es_lb += fkpre[cc] * (double)rsum[st] / (double)rcnt[st];
        }
    es_lb -= 0.5;

    // fix-step ownership: the reference class must provably hold the
    // strict esum maximum (then "fix" can only lower p[r][r])
    double nr_emax = 0.0;
    for (int k = 0; k < 4; ++k)
        if (k != rb2 && (double)esum[k] > nr_emax) nr_emax = (double)esum[k];
    if (!(es_lb > nr_emax)) return 0;

    const double need = (double)p_rr + 1.5;
    const double* cmrow = coefmin + (size_t)n_idx * 256;
    // hom x (x != r): p[x][x] >= esum_r + coef_min(n, c_tot - c_x)
    for (int x = 0; x < 4; ++x) {
        if (x == rb2) continue;
        int32_t t2x = c_tot - cnt[x];
        if (t2x <= 0) return 0;
        if (es_lb + cmrow[t2x < 255 ? t2x : 255] < need) return 0;
    }
    // het r/x: p[r][x] >= -4.343*lhet[c_r][c_x] + coef_min(n, t2h)
    const int32_t cr_idx = cnt[rb2];
    for (int x = 0; x < 4; ++x) {
        if (x == rb2) continue;
        int32_t cx = cnt[x] < 255 ? cnt[x] : 255;
        double lh = -4.343 * gt.lhet[(int64_t)cr_idx * 256 + cx];
        int32_t t2h = c_tot - cnt[rb2] - cnt[x];
        double b = lh - 0.5 +
                   (t2h > 0 ? cmrow[t2h < 255 ? t2h : 255] : 0.0);
        if (b < need) return 0;
    }
    // het x/y (neither is r): pays the full reference esum too
    for (int x = 0; x < 4; ++x) {
        if (x == rb2) continue;
        for (int y = x + 1; y < 4; ++y) {
            if (y == rb2) continue;
            int32_t t2h = c_tot - cnt[x] - cnt[y];
            if (t2h <= 0) return 0;
            if (es_lb + cmrow[t2h < 255 ? t2h : 255] < need) return 0;
        }
    }
    *out_keep = n_all;
    return 1;
}

// Per-site depth/quality statistics for emitted columns (exact
// replication of the reference's get_dqstats, dqstats.c:6-53; see
// output/dqstats.py for the field semantics).  out is [K, 18] int32:
// mean_baseq[4], mean_mapq[4], base_occ[4], dp4[4], total_depth,
// total_mean_mapq.  Quirk preserved: a '=' base (code 0) satisfies
// (base & value) == base for every value, so it counts in all four
// base_occ buckets.
void pileup_dqstats(const NativePileup* np, const int64_t* col_idx,
                    int64_t K, const int32_t* rb4, const int32_t* wanted,
                    int32_t* out) {
    for (int64_t k = 0; k < K; ++k) {
        int32_t* o = out + k * 18;
        for (int i = 0; i < 18; ++i) o[i] = 0;
        int64_t c = col_idx[k];
        int64_t depth = 0, tot_mq = 0;
        int64_t occ[4] = {0, 0, 0, 0};
        int64_t sb[4] = {0, 0, 0, 0}, sm[4] = {0, 0, 0, 0};
        int64_t dp4[4] = {0, 0, 0, 0};
        const int32_t rb = rb4[k];
        const int32_t want = wanted[k];
        for (int64_t i = np->offsets[c]; i < np->offsets[c + 1]; ++i) {
            uint32_t s = np->slots[i];
            if ((s >> 21) & 1) continue;  // deletions excluded
            int32_t b = (int32_t)((s >> 16) & 0xF);
            int32_t bq = (int32_t)((s >> 8) & 0xFF);
            int32_t mq = (int32_t)(s & 0xFF);
            int32_t st = (int32_t)((s >> 20) & 1);
            ++depth;
            tot_mq += mq;
            dp4[(b == rb ? 0 : 2) + st] += 1;
            for (int j = 0; j < 4; ++j) {
                int32_t v = 1 << j;
                if ((b & v) == b) {
                    occ[j] += 1;
                    if (want & v) {
                        sb[j] += bq;
                        sm[j] += mq;
                    }
                }
            }
        }
        for (int j = 0; j < 4; ++j) {
            if (occ[j] > 0) {
                o[j] = (int32_t)((double)sb[j] / (double)occ[j] + 0.499);
                o[4 + j] =
                    (int32_t)((double)sm[j] / (double)occ[j] + 0.499);
            }
            o[8 + j] = (int32_t)occ[j];
            o[12 + j] = (int32_t)dp4[j];
        }
        o[16] = (int32_t)depth;
        o[17] = depth > 0 ? (int32_t)((double)tot_mq / (double)depth + 0.499)
                          : 0;
    }
}

// Test/debug entry: exact consensus + keep count for selected columns.
void glf_cns_batch(const NativePileup* np, const int64_t* col_idx,
                   int64_t B, const int32_t* ref16, const double* coef,
                   const double* lhet, const double* fk, int32_t q_r_int,
                   int32_t* out_cns, int32_t* out_keep) {
    GlfTables gt{coef, lhet, fk, q_r_int};
    for (int64_t b = 0; b < B; ++b)
        out_cns[b] = glf_exact_cns(np, col_idx[b], ref16[b], gt,
                                   &out_keep[b]);
}

// Test/debug entry: near-pure hom-ref proof per column (1 = proven,
// 0 = inconclusive).  Soundness contract under test: proven columns
// must have glf_exact_cns == ref code with the same keep count.
void glf_cns_proof_batch(const NativePileup* np, const int64_t* col_idx,
                         int64_t B, const int32_t* ref16,
                         const double* coef, const double* lhet,
                         const double* fk, int32_t q_r_int,
                         int32_t* out_proven, int32_t* out_keep) {
    GlfTables gt{coef, lhet, fk, q_r_int};
    const double* cm = shortcut_coefmin(coef);
    const double* fp = shortcut_fkpre(fk);
    for (int64_t b = 0; b < B; ++b) {
        out_keep[b] = -1;
        out_proven[b] = glf_cns_homref_proof(np, col_idx[b], ref16[b], gt,
                                             fp, cm, &out_keep[b]);
    }
}

// ---- native exact scorer ---------------------------------------------------
//
// Full exact-mode replication of the per-column scoring pipeline
// downstream of glfgen (see models/consensus.py and models/somatic.py,
// reference somatic_sniper.c:109-273): consensus calling with het
// penalty, solo posteriors or the joint 10x10 prior grid (including the
// stale-index quirk), LOH/GOR gating, statuses.  All integer phred
// arithmetic via the caller-supplied qAdd table — no device round trip.

// sniper_glf2cns semantics (reference sniper_maqcns.c:250-282): three
// strict-< minima over the 10 genotype slots in lk order (equal to the
// reference's 16-slot linear scan; ties keep the earlier slot), plus
// the n==0 guard of sniper_maqcns_call.
static void glf2cns4(const int32_t lk[10], int32_t n_total, int32_t q_r,
                     int32_t* b1, int32_t* b2, int32_t* s1, int32_t* s2) {
    if (n_total == 0) {
        *b1 = 15;
        *b2 = 15;
        *s1 = 0;
        *s2 = 0;
        return;
    }
    int32_t mn = 10000, mn2 = 10000, mn3 = 10000;
    int g1 = -1, g2 = -1;
    for (int i = 0; i < 10; ++i) {
        int32_t t = lk[i] + kHetPen[i] * q_r;
        if (t < mn) {
            mn3 = mn2;
            mn2 = mn;
            mn = t;
            g2 = g1;
            g1 = i;
        } else if (t < mn2) {
            mn3 = mn2;
            mn2 = t;
            g2 = i;
        } else if (t < mn3) {
            mn3 = t;
        }
    }
    *b1 = g1 >= 0 ? kGlfBase[g1] : 15;
    *b2 = g2 >= 0 ? kGlfBase[g2] : 15;
    *s1 = mn2 < 10000 ? (mn2 - mn < 256 ? mn2 - mn : 255) : 255;
    *s2 = (mn2 < 10000 && mn3 < 10000)
              ? (mn3 - mn2 < 256 ? mn3 - mn2 : 255)
              : 255;
}

static inline int32_t qadd_t(const int32_t* tab, int32_t x, int32_t y) {
    // reference somatic_sniper.c:18; index clamp mirrors the JAX op (the
    // reference reads raw memory out of bounds there — unreachable for
    // well-formed inputs, see make_qadd in models/consensus.py)
    int32_t idx = 512 + y - x;
    if (idx < 0) idx = 0;
    if (idx > 1023) idx = 1023;
    return x + tab[idx];
}

// Per-column compact output rows (COMPACT_FIELDS order, leading column
// = plan index), emit-gated.  Returns the emitted-row count.
int64_t exact_pair_rows(
    const NativePileup* t, const NativePileup* n, const int64_t* ti,
    const int64_t* ni, int64_t B, const int32_t* rb4v, const double* coef,
    const double* lhet, const double* fk, int32_t q_r_int,
    const int32_t* qadd, const int32_t* solo_prior,
    const int32_t* joint_prior, int32_t use_joint,
    int32_t min_somatic_qual, int32_t include_loh, int32_t include_gor,
    int32_t* rows) {
    GlfTables gt{coef, lhet, fk, q_r_int};
    std::atomic<int64_t> next(0);
    // emit decisions + row payloads computed in parallel, then packed
    // densely in plan order (deterministic output)
    std::vector<uint8_t> emit_v((size_t)B, 0);
    std::vector<int32_t> payload((size_t)B * 16);
    auto work = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(64);
            if (i >= B) break;
            int64_t hi = i + 64 < B ? i + 64 : B;
            for (; i < hi; ++i) {
                const int32_t rb = rb4v[i];
                int32_t lk_t[10], lk_n[10], keep_t, keep_n;
                glf_exact_lk(t, ti[i], rb, gt, lk_t, &keep_t);
                glf_exact_lk(n, ni[i], rb, gt, lk_n, &keep_n);
                const int32_t n1 =
                    (int32_t)(t->offsets[ti[i] + 1] - t->offsets[ti[i]]);
                const int32_t n2 =
                    (int32_t)(n->offsets[ni[i] + 1] - n->offsets[ni[i]]);
                int32_t tb1, tb2, ts1, ts2, nb1, nb2, ns1, ns2;
                glf2cns4(lk_t, n1, q_r_int, &tb1, &tb2, &ts1, &ts2);
                glf2cns4(lk_n, n2, q_r_int, &nb1, &nb2, &ns1, &ns2);
                // outer + SNP gate (reference somatic_sniper.c:127,156)
                if (!(keep_t > 0 && keep_n > 0 && rb != 15 && tb1 != 15 &&
                      nb1 != 15 && tb1 != nb1))
                    continue;
                int32_t tumor_vaq = tb2 == rb ? ts1 : ts1 + ts2;
                if (tumor_vaq > 255) tumor_vaq = 255;
                int32_t normal_vaq = 0;
                if (nb1 != 15 && nb1 != rb) {
                    normal_vaq = nb2 == rb ? ns1 : ns1 + ns2;
                    if (normal_vaq > 255) normal_vaq = 255;
                }
                int32_t qps = 255;
                int32_t jt_gt = 0, jn_gt = 0, jcq = 255;
                if (use_joint) {
                    const int32_t* jp = joint_prior + (int64_t)rb * 100;
                    int32_t joint[100];
                    int32_t marg = 255, best = 1000;
                    int bi = -1, bj = -1;
                    for (int a = 0; a < 10; ++a)
                        for (int b = 0; b < 10; ++b) {
                            int32_t v =
                                lk_n[a] + lk_t[b] + jp[a * 10 + b];
                            if (v > 255) v = 255;
                            joint[a * 10 + b] = v;
                            if (v < best) {
                                best = v;
                                bi = a;
                                bj = b;
                            }
                            marg = qadd_t(qadd, marg, v);
                        }
                    for (int j = 0; j < 10; ++j) {
                        int32_t lkv = joint[j * 10 + j] - marg;
                        qps = qadd_t(qadd, qps, lkv);
                        // stale-i quirk: guard reduces to j != tumor argmin
                        if (j != bj) jcq = qadd_t(qadd, jcq, lkv);
                    }
                    if (jcq > 255) jcq = 255;
                    jt_gt = kGlfBase[bj];
                    jn_gt = kGlfBase[bi];
                } else {
                    // calculatePosteriors x2 (reference :79-99) + diag sum
                    const int32_t* pr = solo_prior + (int64_t)rb * 10;
                    int32_t xt[10], xn[10], qs_t = 255, qs_n = 255;
                    for (int j = 0; j < 10; ++j) {
                        xt[j] = lk_t[j] + pr[j];
                        qs_t = qadd_t(qadd, xt[j], qs_t);
                        xn[j] = lk_n[j] + pr[j];
                        qs_n = qadd_t(qadd, xn[j], qs_n);
                    }
                    for (int j = 0; j < 10; ++j) {
                        int32_t pt = xt[j] - qs_t;
                        if (pt > 255) pt = 255;
                        int32_t pn = xn[j] - qs_n;
                        if (pn > 255) pn = 255;
                        qps = qadd_t(qadd, qps, pt + pn);
                    }
                }
                // joint-aware effective genotypes (reference :216-223)
                int32_t t_eff = jt_gt ? jt_gt : tb1;
                int32_t n_eff = jn_gt ? jn_gt : nb1;
                // emit gate: threshold + LOH/GOR suppression
                bool loh = (n_eff != t_eff) && ((t_eff & n_eff) == t_eff);
                bool ref_sub = (n_eff != rb) && ((rb & n_eff) == rb);
                bool gor = !ref_sub && ((t_eff & ~n_eff) == rb);
                if (!(min_somatic_qual <= qps && (include_loh || !loh) &&
                      (include_gor || !gor)))
                    continue;
                int32_t t_status;
                if (t_eff == n_eff)
                    t_status = 1;  // GERMLINE
                else if (loh)
                    t_status = 3;  // LOH
                else if (qps > 0)
                    t_status = 2;  // SOMATIC
                else
                    t_status = 4;  // UNKNOWN
                int32_t n_status = nb1 == rb ? 0 : 1;  // WILDTYPE/GERMLINE
                emit_v[(size_t)i] = 1;
                int32_t* o = payload.data() + (size_t)i * 16;
                o[0] = tb1;
                o[1] = nb1;
                o[2] = ts1;
                o[3] = ns1;
                o[4] = tumor_vaq;
                o[5] = normal_vaq;
                o[6] = qps;
                o[7] = jt_gt;
                o[8] = jn_gt;
                o[9] = jcq;
                o[10] = t_status;
                o[11] = n_status;
                o[12] = t_eff;
                o[13] = n_eff;
                o[14] = keep_t;
                o[15] = keep_n;
            }
        }
    };
    int nt = (int)std::thread::hardware_concurrency();
    if (nt > 2) nt = 2;
    if (nt > 1 && B > 512) {
        std::thread th(work);
        work();
        th.join();
    } else {
        work();
    }
    int64_t count = 0;
    for (int64_t i = 0; i < B; ++i) {
        if (!emit_v[(size_t)i]) continue;
        int32_t* o = rows + count * 17;
        o[0] = (int32_t)i;
        memcpy(o + 1, payload.data() + (size_t)i * 16,
               16 * sizeof(int32_t));
        ++count;
    }
    return count;
}

// Fused pair planning: one linear merge over the two sorted ukey lists
// produces, for every column present in BOTH samples and not dropped by
// the pure-reference prefilter, its (key, per-sample column index,
// depths, reference code), grouped by depth bucket.  Replaces four
// separate numpy passes (intersect1d, two pure_flags scans over ALL
// columns of each file, searchsorted bucketing) with one O(shared)
// pass that never touches non-shared columns.
//
// Outputs are caller-allocated with capacity min(t->n_cols, n->n_cols);
// group_off has n_buckets + 2 entries: groups 0..n_buckets-1 are the
// depth buckets, group n_buckets collects oversize columns (depth above
// the last bucket), each group in ascending key order.  Returns the
// total number of kept columns.
//
// Filtering tiers (both sound; output records never change in exact
// mode, and fast mode can only lose emissions the exact model rejects):
//  1. use_prefilter: margin-bound pure-reference test per sample — a
//     cheap scan that proves hom-ref without any table math.
//  2. use_cns (needs coef/lhet): the exact dual-consensus test — drop
//     when the reference's own f64 model gives both samples the same
//     best genotype (the SNP gate, somatic_sniper.c:156, can never
//     pass), when the reference code is ambiguous (rb gate), or when
//     either sample has zero non-deleted reads (depth gate).  Runs on
//     two threads over the shared columns that survive tier 1.
//     use_cns == 2 is the PROOF-ONLY variant (fast/device mode): the
//     cheap near-pure hom-ref proof (tier 2a) still resolves ~90% of
//     the impure columns, but when it is inconclusive the column is
//     KEPT instead of paying the full f64 dual-consensus eval — the
//     device kernel applies the whole emission gate anyway, so the
//     host trades a few extra shipped columns for the expensive
//     glf_exact_cns calls.  (Exact mode keeps use_cns == 1: its
//     survivors are scored host-side, so pre-gating pays for itself.)
int64_t paired_plan(const NativePileup* t, const NativePileup* n,
                    const uint8_t* ref16, const int64_t* ref_off,
                    int32_t n_ref, const double* fk, const double* gmin,
                    double margin, int use_prefilter,
                    const double* coef, const double* lhet,
                    int32_t q_r_int, int use_cns,
                    const int32_t* buckets, int32_t n_buckets,
                    int64_t* keys_out, int64_t* ti_out, int64_t* ni_out,
                    int32_t* dt_out, int32_t* dn_out, int32_t* r16_out,
                    int64_t* group_off) {
    const int64_t POS_MASK = ((int64_t)1 << 40) - 1;
    struct Rec {
        int64_t key, ti, ni;
        int32_t dt, dn, r16, grp;
    };
    // phase 1: serial merge; cheap tier-1 filter inline, tier-2
    // candidates collected with per-sample purity noted (a pure sample's
    // consensus is hom-ref by the margin proof — no glfgen needed)
    struct Cand {
        int64_t key, ti, ni;
        int32_t r16;
        uint8_t pure_t, pure_n;
    };
    // when both samples carry fused pure-reference flags, the tier-1
    // drop happens inline here: ~80-90% of shared columns never become
    // candidates, so phases 2 and 3 iterate (and write) 5-10x less
    const bool inline_pure =
        use_prefilter && t->pure != nullptr && n->pure != nullptr;
    auto merge_range = [&](int64_t it, int64_t it_hi, int64_t in,
                           int64_t in_hi, std::vector<Cand>& out) {
        while (it < it_hi && in < in_hi) {
            int64_t kt = t->ukeys[it], kn = n->ukeys[in];
            if (kt < kn) {
                ++it;
                continue;
            }
            if (kn < kt) {
                ++in;
                continue;
            }
            uint8_t pt_ = 0, pn_ = 0;
            if (inline_pure) {
                pt_ = t->pure[it];
                pn_ = n->pure[in];
                if (pt_ && pn_) {
                    ++it;
                    ++in;
                    continue;
                }
            }
            int32_t tid = (int32_t)(kt >> 40);
            int64_t pos = kt & POS_MASK;
            int32_t rc = 15;
            if (tid >= 0 && tid < n_ref &&
                pos < ref_off[tid + 1] - ref_off[tid])
                rc = (int32_t)ref16[ref_off[tid] + pos];
            out.push_back({kt, it, in, rc, pt_, pn_});
            ++it;
            ++in;
        }
    };
    std::vector<Cand> cands;
    int64_t cap = t->n_cols < n->n_cols ? t->n_cols : n->n_cols;
    cands.reserve((size_t)cap);
    int nthr = (int)std::thread::hardware_concurrency();
    if (nthr > 1 && cap > (1 << 18)) {
        // split the key space at the normal sample's midpoint key; both
        // halves merge independently (shared keys strictly partition)
        int64_t in_mid = n->n_cols / 2;
        int64_t pivot = n->ukeys[in_mid];
        int64_t it_mid = (int64_t)(std::lower_bound(
                             t->ukeys, t->ukeys + t->n_cols, pivot) -
                         t->ukeys);
        std::vector<Cand> hi_cands;
        hi_cands.reserve((size_t)(cap - in_mid));
        std::thread th([&]() {
            merge_range(it_mid, t->n_cols, in_mid, n->n_cols, hi_cands);
        });
        merge_range(0, it_mid, 0, in_mid, cands);
        th.join();
        cands.insert(cands.end(), hi_cands.begin(), hi_cands.end());
    } else {
        merge_range(0, t->n_cols, 0, n->n_cols, cands);
    }
    // phase 2: purity + exact dual-consensus filters, parallel over the
    // shared columns (the serial merge above stays cheap)
    int64_t nc = (int64_t)cands.size();
    std::vector<uint8_t> drop((size_t)nc, 0);
    if (use_prefilter || (use_cns && coef && lhet)) {
        GlfTables gt{coef, lhet, fk, q_r_int};
        bool cns_on = use_cns && coef && lhet;
        const double* sc_coefmin =
            cns_on ? shortcut_coefmin(coef) : nullptr;
        const double* sc_fkpre = cns_on ? shortcut_fkpre(fk) : nullptr;
        auto work = [&](int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; ++i) {
                Cand& cd = cands[(size_t)i];
                if (use_prefilter && !inline_pure) {
                    cd.pure_t =
                        t->pure ? t->pure[cd.ti]
                                : column_pure_ref(t, cd.ti,
                                                  (uint8_t)cd.r16, fk,
                                                  gmin, margin);
                    cd.pure_n =
                        n->pure ? n->pure[cd.ni]
                                : column_pure_ref(n, cd.ni,
                                                  (uint8_t)cd.r16, fk,
                                                  gmin, margin);
                    if (cd.pure_t && cd.pure_n) {
                        drop[(size_t)i] = 1;
                        continue;
                    }
                }
                if (!cns_on) continue;
                if (cd.r16 == 15) {  // rb gate can never pass
                    drop[(size_t)i] = 1;
                    continue;
                }
                const bool full = (use_cns != 2);
                int32_t keep_t = 1, keep_n = 1;
                int resolved_t = 1, resolved_n = 1;
                int32_t cns_t = -1;
                if (cd.pure_t)
                    cns_t = cd.r16;
                else if (glf_cns_homref_proof(t, cd.ti, cd.r16, gt,
                                              sc_fkpre, sc_coefmin,
                                              &keep_t))
                    cns_t = cd.r16;
                else if (full)
                    cns_t = glf_exact_cns(t, cd.ti, cd.r16, gt, &keep_t);
                else
                    resolved_t = 0;  // proof-only: keep, device decides
                if (resolved_t && keep_t == 0) {
                    drop[(size_t)i] = 1;
                    continue;
                }
                if (!resolved_t) continue;  // proof-only: drop needs both
                int32_t cns_n = -2;
                if (cd.pure_n)
                    cns_n = cd.r16;
                else if (glf_cns_homref_proof(n, cd.ni, cd.r16, gt,
                                              sc_fkpre, sc_coefmin,
                                              &keep_n))
                    cns_n = cd.r16;
                else if (full)
                    cns_n = glf_exact_cns(n, cd.ni, cd.r16, gt, &keep_n);
                else
                    resolved_n = 0;
                drop[(size_t)i] = resolved_t && resolved_n &&
                                  ((keep_n == 0) || (cns_t == cns_n));
            }
        };
        int64_t nt = std::thread::hardware_concurrency();
        if (nt > 2) nt = 2;
        if (nt > 1 && nc > 4096) {
            int64_t mid = nc / 2;
            std::thread th(work, 0, mid);
            work(mid, nc);
            th.join();
        } else {
            work(0, nc);
        }
    }
    // phase 3: bucket + emit in ascending key order per group
    std::vector<int64_t> cnt((size_t)n_buckets + 1, 0);
    std::vector<int32_t> grp((size_t)nc, 0);
    std::vector<int32_t> dts((size_t)nc, 0), dns((size_t)nc, 0);
    int64_t n_keep = 0;
    for (int64_t i = 0; i < nc; ++i) {
        if (drop[(size_t)i]) continue;
        const Cand& cd = cands[(size_t)i];
        int32_t dt = (int32_t)(t->offsets[cd.ti + 1] - t->offsets[cd.ti]);
        int32_t dn = (int32_t)(n->offsets[cd.ni + 1] - n->offsets[cd.ni]);
        int32_t dmax = dt > dn ? dt : dn;
        int32_t g = n_buckets;  // oversize
        for (int32_t bi = 0; bi < n_buckets; ++bi)
            if (dmax <= buckets[bi]) {
                g = bi;
                break;
            }
        grp[(size_t)i] = g;
        dts[(size_t)i] = dt;
        dns[(size_t)i] = dn;
        ++cnt[(size_t)g];
        ++n_keep;
    }
    group_off[0] = 0;
    for (int32_t g = 0; g <= n_buckets; ++g)
        group_off[g + 1] = group_off[g] + cnt[(size_t)g];
    std::vector<int64_t> cur(group_off, group_off + n_buckets + 1);
    for (int64_t i = 0; i < nc; ++i) {
        if (drop[(size_t)i]) continue;
        const Cand& cd = cands[(size_t)i];
        int64_t o = cur[(size_t)grp[(size_t)i]]++;
        keys_out[o] = cd.key;
        ti_out[o] = cd.ti;
        ni_out[o] = cd.ni;
        dt_out[o] = dts[(size_t)i];
        dn_out[o] = dns[(size_t)i];
        r16_out[o] = cd.r16;
    }
    return n_keep;
}

// ---- bulk text emission ----------------------------------------------------
//
// Native replication of output/fast_emit.py's line builders (themselves
// byte-identical to the reference writers output_classic.c /
// output_vcf.c / output_bed.c — see output/formatters.py for the
// field-by-field citations).  Emitted-site text formatting was ~25% of
// the exact-mode main thread at 10 Mb when done with Python f-strings;
// this renders all K lines in one C pass into a caller-provided buffer.

static inline char* emit_put_u64(char* p, uint64_t v) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + (v % 10));
        v /= 10;
    } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

static inline char* emit_put_i64(char* p, int64_t v) {
    if (v < 0) {
        *p++ = '-';
        return emit_put_u64(p, (uint64_t)(-v));
    }
    return emit_put_u64(p, (uint64_t)v);
}

// print_mean_quality_values / print_base_count (reference dqstats.c:
// 55-88): comma-joined row[off+i] for set bits i of bases; "0" if none.
static inline char* emit_mv(char* p, int64_t bases, const int32_t* row,
                            int off) {
    int b = (int)(bases & 0xF);
    if (b == 0) {
        *p++ = '0';
        return p;
    }
    bool first = true;
    for (int i = 0; i < 4; ++i) {
        if (!(b & (1 << i))) continue;
        if (!first) *p++ = ',';
        first = false;
        p = emit_put_i64(p, row[off + i]);
    }
    return p;
}

// output_vcf_gt (reference output_vcf.c:46-79); matches
// output/formatters._vcf_gt exactly (incl. the no-'/'-before-first
// allele join order).
static inline char* emit_vcf_gt(char* p, int64_t ref_base, int64_t alts,
                                int64_t gt) {
    int allele_count = __builtin_popcount((unsigned)(gt & 0xF));
    int out_count = 0;
    if (gt & ref_base) {
        if (allele_count == 1) {
            *p++ = '0';
            *p++ = '/';
            *p++ = '0';
            return p;
        }
        *p++ = '0';
        ++out_count;
    }
    gt &= ~ref_base;
    int allele_idx = 0;
    for (int i = 0; i < 4; ++i) {
        int value = 1 << i;
        if (alts & value) ++allele_idx;
        if (gt & value) {
            if (allele_count == 1) {
                *p++ = (char)('0' + allele_idx);
                *p++ = '/';
                *p++ = (char)('0' + allele_idx);
                return p;
            }
            if (out_count > 0) *p++ = '/';
            *p++ = (char)('0' + allele_idx);
            ++out_count;
        }
    }
    return p;
}

// output_vcf_sample (reference output_vcf.c:81-133) over a raw
// [18] dqstats row; ssc < 0 prints '.' (the NORMAL sample).
static inline char* emit_vcf_sample(char* p, int64_t ref4, int64_t alts,
                                    int64_t gt_i, int64_t jgt, int64_t jcq,
                                    int64_t cq, int64_t vaq, int64_t ssc,
                                    int64_t st, const int32_t* d) {
    if (jgt) {
        p = emit_vcf_gt(p, ref4, alts, jgt);
        *p++ = ':';
        p = emit_vcf_gt(p, ref4, alts, gt_i);
    } else {
        p = emit_vcf_gt(p, ref4, alts, gt_i);
        *p++ = ':';
        p = emit_vcf_gt(p, ref4, alts, gt_i);
    }
    *p++ = ':';
    p = emit_put_i64(p, d[16]);
    *p++ = ':';
    for (int i = 12; i < 16; ++i) {
        p = emit_put_i64(p, d[i]);
        if (i < 15) *p++ = ',';
    }
    *p++ = ':';
    for (int i = 8; i < 12; ++i) {
        p = emit_put_i64(p, d[i]);
        if (i < 11) *p++ = ',';
    }
    *p++ = ':';
    p = emit_put_i64(p, cq);
    *p++ = ':';
    if (jgt)
        p = emit_put_i64(p, jcq);
    else
        *p++ = '.';
    *p++ = ':';
    p = emit_put_i64(p, vaq);
    *p++ = ':';
    p = emit_mv(p, gt_i, d, 0);
    *p++ = ':';
    p = emit_put_i64(p, d[17]);
    *p++ = ':';
    p = emit_mv(p, gt_i, d, 4);
    *p++ = ':';
    p = emit_put_i64(p, st);
    *p++ = ':';
    if (ssc >= 0)
        p = emit_put_i64(p, ssc);
    else
        *p++ = '.';
    return p;
}

// Field order = models/somatic.COMPACT_FIELDS.
enum {
    EF_TGT = 0, EF_NGT, EF_TCQ, EF_NCQ, EF_TVAQ, EF_NVAQ, EF_SCORE,
    EF_TJGT, EF_NJGT, EF_JCQ, EF_TST, EF_NST,
};

// Render K output lines (fmt 0=classic 1=vcf 2=bed) into out[cap].
// names_blob/names_off: contig-name bytes indexed per row via tids.
// fields: [K, nf] int64 in COMPACT_FIELDS order; rows_t/rows_n:
// [K, 18] dqstats rows (pileup_dqstats layout).  line_off receives
// K+1 byte offsets.  Returns total bytes written, or -1 when the
// buffer may be too small (caller grows and retries).
int64_t emit_lines(int32_t fmt, int64_t K, const char* names_blob,
                   const int64_t* names_off, const int64_t* tids,
                   const int64_t* poss, const int32_t* chars,
                   const int32_t* rb4, const int64_t* fields, int64_t nf,
                   const int32_t* rows_t, const int32_t* rows_n, char* out,
                   int64_t cap, int64_t* line_off) {
    static const char NT16_REV[17] = "=ACMGRSVTWYHKDBN";
    char* p = out;
    for (int64_t k = 0; k < K; ++k) {
        const int64_t* f = fields + k * nf;
        const int32_t* rt = rows_t + k * 18;
        const int32_t* rn = rows_n + k * 18;
        const int64_t tid = tids[k];
        const char* name = names_blob + names_off[tid];
        const int64_t name_len = names_off[tid + 1] - names_off[tid];
        // provable per-line bound, adversarial values included: the
        // widest line is VCF with 2 samples x 13 fields x up to 4
        // comma values, each an int64 (<= 20 digits + sign) plus a
        // separator = 2*13*4*22 = 2288; classic is smaller (12 multi-
        // value dqstats columns x 4 values x 22 = 1056 + ~14 scalars
        // x 22).  4096 covers either with separators/fixed text to
        // spare (realistic phred/depth values use a tenth of this).
        if ((p - out) + name_len + 4096 > cap) return -1;
        line_off[k] = p - out;
        const int64_t r4 = rb4[k];
        const int64_t tg = f[EF_TGT], ng = f[EF_NGT];
        if (fmt == 2) {  // bed (output_bed.c)
            memcpy(p, name, (size_t)name_len);
            p += name_len;
            *p++ = '\t';
            p = emit_put_i64(p, poss[k]);
            *p++ = '\t';
            p = emit_put_i64(p, poss[k] + 1);
            *p++ = '\t';
            *p++ = (char)chars[k];
            *p++ = '/';
            *p++ = NT16_REV[tg & 0xF];
            *p++ = '\t';
            p = emit_put_i64(p, f[EF_SCORE]);
            *p++ = '\t';
            p = emit_put_i64(p, rt[16]);
            *p++ = '\n';
            continue;
        }
        if (fmt == 1) {  // vcf (output_vcf.c)
            const int64_t alts = (tg | ng) & ~r4 & 0xF;
            memcpy(p, name, (size_t)name_len);
            p += name_len;
            *p++ = '\t';
            p = emit_put_i64(p, poss[k] + 1);
            *p++ = '\t';
            *p++ = '.';
            *p++ = '\t';
            *p++ = (char)chars[k];
            *p++ = '\t';
            if (alts == 0) {
                *p++ = '.';
            } else {
                bool first = true;
                for (int i = 0; i < 4; ++i) {
                    if (!(alts & (1 << i))) continue;
                    if (!first) *p++ = ',';
                    first = false;
                    *p++ = "ACGT"[i];
                }
            }
            static const char FMT[] =
                "\t.\t.\t.\tGT:IGT:DP:DP4:BCOUNT:GQ:JGQ:VAQ:BQ:MQ:AMQ:"
                "SS:SSC\t";
            memcpy(p, FMT, sizeof(FMT) - 1);
            p += sizeof(FMT) - 1;
            p = emit_vcf_sample(p, r4, alts, ng, f[EF_NJGT], f[EF_JCQ],
                                f[EF_NCQ], f[EF_NVAQ], -1, f[EF_NST], rn);
            *p++ = '\t';
            p = emit_vcf_sample(p, r4, alts, tg, f[EF_TJGT], f[EF_JCQ],
                                f[EF_TCQ], f[EF_TVAQ], f[EF_SCORE],
                                f[EF_TST], rt);
            *p++ = '\n';
            continue;
        }
        // classic (output_classic.c:9-55): 26 tab-separated columns
        memcpy(p, name, (size_t)name_len);
        p += name_len;
        *p++ = '\t';
        p = emit_put_i64(p, poss[k] + 1);
        *p++ = '\t';
        *p++ = (char)chars[k];
        *p++ = '\t';
        *p++ = NT16_REV[tg & 0xF];
        *p++ = '\t';
        *p++ = NT16_REV[ng & 0xF];
        *p++ = '\t';
        p = emit_put_i64(p, f[EF_SCORE]);
        *p++ = '\t';
        p = emit_put_i64(p, f[EF_TCQ]);
        *p++ = '\t';
        p = emit_put_i64(p, f[EF_TVAQ]);
        *p++ = '\t';
        p = emit_put_i64(p, rt[17]);
        *p++ = '\t';
        p = emit_put_i64(p, f[EF_NCQ]);
        *p++ = '\t';
        p = emit_put_i64(p, f[EF_NVAQ]);
        *p++ = '\t';
        p = emit_put_i64(p, rn[17]);
        *p++ = '\t';
        p = emit_put_i64(p, rt[16]);
        *p++ = '\t';
        p = emit_put_i64(p, rn[16]);
        *p++ = '\t';
        p = emit_mv(p, r4, rt, 0);
        *p++ = '\t';
        p = emit_mv(p, r4, rt, 4);
        *p++ = '\t';
        p = emit_mv(p, r4, rt, 8);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & tg, rt, 0);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & tg, rt, 4);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & tg, rt, 8);
        *p++ = '\t';
        p = emit_mv(p, r4, rn, 0);
        *p++ = '\t';
        p = emit_mv(p, r4, rn, 4);
        *p++ = '\t';
        p = emit_mv(p, r4, rn, 8);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & ng, rn, 0);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & ng, rn, 4);
        *p++ = '\t';
        p = emit_mv(p, ~r4 & ng, rn, 8);
        *p++ = '\n';
    }
    line_off[K] = p - out;
#ifdef SNIPER_PLANT_OVERRUN
    // test-only canary (never defined in production builds): a 1-byte
    // heap overrun of the caller's buffer, used to prove the ASAN e2e
    // harness actually detects overruns in this function
    if (K > 0) out[cap] = 'X';
#endif
    return p - out;
}

}  // extern "C"
