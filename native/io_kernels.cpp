// Host-side streaming kernels (C API for ctypes).
//
// Equivalents of the reference's host plumbing: the IQ byte-format
// dequantizers (examples/app_helpers/app_iq_readers.h:19-159, 14 sample
// formats with bias/scale), the soft<->hard bit converter
// (examples/app_helpers/app_viterbi_convert_block.h), and a lock-based SPSC
// ring buffer replacing ThreadedRingBuffer (app_io_buffers.h:189-245) for
// feeding the device ingest pipeline without dropping samples.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------- IQ dequantization ----------------
// format codes: 0=u8 1=s8 2=u16le 3=s16le 4=u16be 5=s16be
//               6=u32le 7=s32le 8=u32be 9=s32be 10=f32le 11=f32be
//               12=f64le 13=f64be
// Output: interleaved float32 I/Q normalised to roughly [-1, 1].

static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

int64_t iq_convert(const uint8_t* in, int64_t nb_in_bytes, int format,
                   float* out /* 2*nb_samples floats */) {
    switch (format) {
    case 0: {  // u8: (x - 127.5) / 127.5 (reference QuantisedIQ<uint8_t>)
        const int64_t n = nb_in_bytes;
        for (int64_t i = 0; i < n; i++)
            out[i] = (float(in[i]) - 127.5f) / 127.5f;
        return n / 2;
    }
    case 1: {
        const auto* p = reinterpret_cast<const int8_t*>(in);
        const int64_t n = nb_in_bytes;
        for (int64_t i = 0; i < n; i++) out[i] = float(p[i]) / 127.0f;
        return n / 2;
    }
    case 2: case 4: {
        const auto* p = reinterpret_cast<const uint16_t*>(in);
        const int64_t n = nb_in_bytes / 2;
        const bool swap = (format == 4);
        for (int64_t i = 0; i < n; i++) {
            uint16_t v = swap ? bswap16(p[i]) : p[i];
            out[i] = (float(v) - 32767.5f) / 32767.5f;
        }
        return n / 2;
    }
    case 3: case 5: {
        const auto* p = reinterpret_cast<const uint16_t*>(in);
        const int64_t n = nb_in_bytes / 2;
        const bool swap = (format == 5);
        for (int64_t i = 0; i < n; i++) {
            uint16_t v = swap ? bswap16(p[i]) : p[i];
            out[i] = float(int16_t(v)) / 32767.0f;
        }
        return n / 2;
    }
    case 6: case 8: {
        const auto* p = reinterpret_cast<const uint32_t*>(in);
        const int64_t n = nb_in_bytes / 4;
        const bool swap = (format == 8);
        for (int64_t i = 0; i < n; i++) {
            uint32_t v = swap ? bswap32(p[i]) : p[i];
            out[i] = (float(v) - 2147483647.5f) / 2147483647.5f;
        }
        return n / 2;
    }
    case 7: case 9: {
        const auto* p = reinterpret_cast<const uint32_t*>(in);
        const int64_t n = nb_in_bytes / 4;
        const bool swap = (format == 9);
        for (int64_t i = 0; i < n; i++) {
            uint32_t v = swap ? bswap32(p[i]) : p[i];
            out[i] = float(int32_t(v)) / 2147483647.0f;
        }
        return n / 2;
    }
    case 10: case 11: {
        const auto* p = reinterpret_cast<const uint32_t*>(in);
        const int64_t n = nb_in_bytes / 4;
        const bool swap = (format == 11);
        for (int64_t i = 0; i < n; i++) {
            uint32_t v = swap ? bswap32(p[i]) : p[i];
            float f;
            std::memcpy(&f, &v, 4);
            out[i] = f;
        }
        return n / 2;
    }
    case 12: case 13: {
        const auto* p = reinterpret_cast<const uint64_t*>(in);
        const int64_t n = nb_in_bytes / 8;
        const bool swap = (format == 13);
        for (int64_t i = 0; i < n; i++) {
            uint64_t v = swap ? bswap64(p[i]) : p[i];
            double d;
            std::memcpy(&d, &v, 8);
            out[i] = float(d);
        }
        return n / 2;
    }
    default:
        return -1;
    }
}

// inverse: quantize interleaved float IQ to u8 (for the transmitter apps)
void iq_quantize_u8(const float* in, int64_t nb_floats, uint8_t* out) {
    // exact inverse of the u8 read path (reference QuantisedIQ::from_iq
    // with the normalised [-1,1] convention): v*127.5 + 127.5, clamp, trunc
    for (int64_t i = 0; i < nb_floats; i++) {
        float v = in[i] * 127.5f + 127.5f;
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        out[i] = uint8_t(v);
    }
}

// ---------------- soft <-> hard bits ----------------
// soft: int8 where >0 means logical 1; hard: MSB-first packed bytes

void soft_to_hard(const int8_t* soft, int64_t nb_bits, uint8_t* packed) {
    const int64_t nb_bytes = nb_bits / 8;
    for (int64_t i = 0; i < nb_bytes; i++) {
        uint8_t b = 0;
        for (int k = 0; k < 8; k++) {
            b = uint8_t(b << 1) | uint8_t(soft[i * 8 + k] > 0);
        }
        packed[i] = b;
    }
}

void hard_to_soft(const uint8_t* packed, int64_t nb_bits, int8_t soft_high,
                  int8_t* soft) {
    for (int64_t i = 0; i < nb_bits; i++) {
        const int bit = (packed[i / 8] >> (7 - (i % 8))) & 1;
        soft[i] = bit ? soft_high : int8_t(-soft_high);
    }
}

// ---------------- blocking SPSC ring buffer ----------------

struct RingBuffer {
    std::vector<uint8_t> buf;
    size_t head = 0, tail = 0, size = 0;
    std::mutex m;
    std::condition_variable cv_read, cv_write;
    bool closed = false;
};

void* ring_create(int64_t capacity) {
    auto* r = new RingBuffer();
    r->buf.resize(size_t(capacity));
    return r;
}

void ring_destroy(void* h) { delete static_cast<RingBuffer*>(h); }

void ring_close(void* h) {
    auto* r = static_cast<RingBuffer*>(h);
    std::lock_guard<std::mutex> lk(r->m);
    r->closed = true;
    r->cv_read.notify_all();
    r->cv_write.notify_all();
}

// blocking write; returns bytes written (< n only if closed)
int64_t ring_write(void* h, const uint8_t* data, int64_t n) {
    auto* r = static_cast<RingBuffer*>(h);
    int64_t written = 0;
    while (written < n) {
        std::unique_lock<std::mutex> lk(r->m);
        r->cv_write.wait(lk, [&] {
            return r->closed || r->size < r->buf.size();
        });
        if (r->closed) break;
        const size_t avail = r->buf.size() - r->size;
        const size_t chunk = std::min<size_t>(avail, size_t(n - written));
        for (size_t i = 0; i < chunk; i++) {
            r->buf[r->tail] = data[written + int64_t(i)];
            r->tail = (r->tail + 1) % r->buf.size();
        }
        r->size += chunk;
        written += int64_t(chunk);
        r->cv_read.notify_one();
    }
    return written;
}

// blocking read of exactly n bytes (less only when closed and drained)
int64_t ring_read(void* h, uint8_t* data, int64_t n) {
    auto* r = static_cast<RingBuffer*>(h);
    int64_t got = 0;
    while (got < n) {
        std::unique_lock<std::mutex> lk(r->m);
        r->cv_read.wait(lk, [&] { return r->closed || r->size > 0; });
        if (r->size == 0 && r->closed) break;
        const size_t chunk = std::min<size_t>(r->size, size_t(n - got));
        for (size_t i = 0; i < chunk; i++) {
            data[got + int64_t(i)] = r->buf[r->head];
            r->head = (r->head + 1) % r->buf.size();
        }
        r->size -= chunk;
        got += int64_t(chunk);
        r->cv_write.notify_one();
    }
    return got;
}

int64_t ring_size(void* h) {
    auto* r = static_cast<RingBuffer*>(h);
    std::lock_guard<std::mutex> lk(r->m);
    return int64_t(r->size);
}

// ---------------- Parametric-stereo decorrelator ----------------
// The PS transient ducker and 3-link allpass chain are short sequential
// IIRs over QMF slots (dab/ps_synth.py:decorrelate keeps the NumPy loops
// as the fallback/reference); per-slot Python dispatch dominated host
// HE-AAC v2 decode. Complex128 arrays pass as interleaved double pairs
// (same memory layout). Arithmetic mirrors the NumPy expressions exactly
// (same multiply/add structure), so outputs are bit-identical.

void ps_ducker(const double* power /* npar*n */, int64_t npar, int64_t n,
               double* pk, double* psm, double* pdds /* (npar,) in/out */,
               double peak_decay, double a_smooth, double transient_impact,
               double* gain /* out npar*n */) {
    for (int64_t t = 0; t < n; t++) {
        for (int64_t i = 0; i < npar; i++) {
            const double p = power[i * n + t];
            const double dk = peak_decay * pk[i];
            pk[i] = dk > p ? dk : p;
            psm[i] += a_smooth * (p - psm[i]);
            pdds[i] += a_smooth * (pk[i] - p - pdds[i]);
            const double denom = transient_impact * pdds[i];
            gain[i * n + t] = denom > psm[i]
                ? psm[i] / (denom > 1e-30 ? denom : 1e-30) : 1.0;
        }
    }
}

void ps_allpass(const double* v_in /* nap*n complex */, int64_t nap,
                int64_t n, int64_t ap_total /* time length of ap */,
                const double* ag /* nap*3 */, const double* q /* nap*3 cplx */,
                const int64_t* link_delay /* 3 */, int64_t ap_delay,
                double* ap /* nap*3*ap_total complex, in/out */,
                double* out /* nap*n complex */) {
    for (int64_t t = 0; t < n; t++) {
        for (int64_t k = 0; k < nap; k++) {
            double vr = v_in[(k * n + t) * 2];
            double vi = v_in[(k * n + t) * 2 + 1];
            for (int64_t m = 0; m < 3; m++) {
                const double g = ag[k * 3 + m];
                const double ar = g * vr, ai = g * vi;
                const int64_t base = ((k * 3 + m) * ap_total);
                const int64_t tl = base + t + ap_delay - link_delay[m];
                const double lr = ap[tl * 2], li = ap[tl * 2 + 1];
                const double qr = q[(k * 3 + m) * 2];
                const double qi = q[(k * 3 + m) * 2 + 1];
                const double nvr = lr * qr - li * qi - ar;
                const double nvi = lr * qi + li * qr - ai;
                const int64_t tw = base + t + ap_delay;
                ap[tw * 2] = vr + g * nvr;
                ap[tw * 2 + 1] = vi + g * nvi;
                vr = nvr; vi = nvi;
            }
            out[(k * n + t) * 2] = vr;
            out[(k * n + t) * 2 + 1] = vi;
        }
    }
}

// ---------------- CRC16 (MSB-first, table-driven) ----------------
// Byte-at-a-time engine matching the reference CRC_Calculator<uint16_t>
// (src/dab/algorithms/crc.h:11-69). The 256-entry table comes from the
// caller (ops/crc.py builds it per polynomial), so this stays a pure
// streaming kernel: the AU / data-group CRC checks are the host byte
// layer's per-superframe hot loop once RS is table-driven.
uint32_t crc16_block(const uint8_t* data, int64_t n, const uint16_t* lut,
                     uint32_t init, uint32_t final_xor) {
    uint16_t crc = uint16_t(init);
    for (int64_t i = 0; i < n; i++)
        crc = uint16_t((crc << 8) ^ lut[((crc >> 8) ^ data[i]) & 0xFF]);
    return uint32_t(crc ^ uint16_t(final_xor));
}

// Ragged batch: m buffers packed back-to-back in `data`, buffer i spanning
// [offsets[i], offsets[i+1]). One ctypes call per superframe/round instead
// of one per access unit — the ~9 us Python+ffi prologue per call was the
// host byte layer's AU-CRC cost, not the CRC itself.
void crc16_blocks(const uint8_t* data, const int64_t* offsets, int64_t m,
                  const uint16_t* lut, uint32_t init, uint32_t final_xor,
                  uint16_t* out) {
    for (int64_t k = 0; k < m; k++) {
        uint16_t crc = uint16_t(init);
        for (int64_t i = offsets[k]; i < offsets[k + 1]; i++)
            crc = uint16_t((crc << 8) ^ lut[((crc >> 8) ^ data[i]) & 0xFF]);
        out[k] = uint16_t(crc ^ uint16_t(final_xor));
    }
}

}  // extern "C"
