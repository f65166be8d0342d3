// Async double-buffered block prefetcher: the native IO runtime that keeps
// the device-side sweep fed.
//
// The reference streams files synchronously from Python one block at a
// time (e.g. formats/filterbank.py:109-119 read loops, fbobs cross-file
// reads); at TPU sweep rates the read sits on the critical path.  This
// reader owns a background thread that stays ``depth`` overlap-save blocks
// ahead of the consumer (pread into a ring of reusable buffers), so disk
// latency overlaps device compute — the host analogue of the sweep's
// MAX_PENDING dispatch pipeline (parallel/sweep.py).  The port's ship-ahead
// thread (parallel/prefetch.py) copies each acquired buffer into pinned
// memory before it releases it.  Slot buffers are left uninitialised
// (pread fills them) and outlive their ring: pf_close hands them to a
// process-wide pool of at most kPoolMax, from which the next ring takes
// the smallest that fits.  A fresh buffer's first touch (the kernel's
// page faults and zero-fill) cost as much as the pread into it, so a
// pass over a file pays it once, not once a ring.
//
// C API (ctypes-bound in pypulsar_tpu_torch/native/__init__.py):
//   pf_open(path, data_offset, bytes_per_spec, total_spec,
//           payload_spec, overlap_spec, depth) -> handle (NULL on error)
//   pf_acquire(handle, &buf, &start_spec, &nspec) -> 1 block ready,
//           0 end-of-stream, -1 IO error; blocks until one is ready.
//           The buffer stays valid until the matching pf_release.
//   pf_release(handle)  -- return the oldest acquired buffer to the ring
//   pf_close(handle)
//
// A truncated file ends the stream with a short block; the binding raises
// on it (a block shorter than min(payload + overlap, total - start)).
//
// Built into libpsrcodec-<digest>.so alongside codec.cpp
// (pypulsar_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Buffer {
    std::unique_ptr<uint8_t[]> data;
    int64_t cap = 0;     // bytes allocated in data
};

constexpr size_t kPoolMax = 3;  // a default ring's slots
std::mutex g_pool_m;
std::vector<Buffer> g_pool;

// The smallest pooled buffer of at least `want` bytes, else a new one.
Buffer take_buffer(int64_t want) {
    {
        std::lock_guard<std::mutex> lk(g_pool_m);
        size_t best = g_pool.size();
        for (size_t i = 0; i < g_pool.size(); ++i) {
            if (g_pool[i].cap >= want &&
                (best == g_pool.size() || g_pool[i].cap < g_pool[best].cap))
                best = i;
        }
        if (best < g_pool.size()) {
            Buffer b = std::move(g_pool[best]);
            g_pool.erase(g_pool.begin() + static_cast<ptrdiff_t>(best));
            return b;
        }
    }
    Buffer b;
    b.data.reset(new uint8_t[static_cast<size_t>(want)]);
    b.cap = want;
    return b;
}

// Keep a buffer for a later ring; past kPoolMax the smallest is freed.
void give_buffer(Buffer b) {
    if (!b.data) return;
    std::lock_guard<std::mutex> lk(g_pool_m);
    g_pool.push_back(std::move(b));
    if (g_pool.size() > kPoolMax) {
        size_t small = 0;
        for (size_t i = 1; i < g_pool.size(); ++i)
            if (g_pool[i].cap < g_pool[small].cap) small = i;
        g_pool.erase(g_pool.begin() + static_cast<ptrdiff_t>(small));
    }
}

struct Slot {
    Buffer buf;
    int64_t start = 0;   // first spectrum index in the block
    int64_t nspec = 0;   // spectra in the block
    bool full = false;
};

struct Prefetcher {
    int fd = -1;
    int64_t data_offset = 0;
    int64_t bytes_per_spec = 0;
    int64_t total_spec = 0;
    int64_t payload = 0;
    int64_t overlap = 0;

    std::vector<Slot> ring;
    size_t prod = 0;     // next slot the reader fills
    size_t cons = 0;     // next slot the consumer acquires
    bool eof = false;
    bool io_error = false;
    bool stop = false;

    std::mutex m;
    std::condition_variable cv_slot_free;
    std::condition_variable cv_slot_full;
    std::thread th;

    void reader_loop() {
        int64_t pos = 0;
        while (true) {
            int64_t n = total_spec - pos;
            if (n <= 0) break;
            if (n > payload + overlap) n = payload + overlap;
            Slot* slot;
            {
                std::unique_lock<std::mutex> lk(m);
                cv_slot_free.wait(lk, [&] {
                    return stop || !ring[prod % ring.size()].full;
                });
                if (stop) return;
                slot = &ring[prod % ring.size()];
            }
            const int64_t want = n * bytes_per_spec;
            if (slot->buf.cap < want) {
                give_buffer(std::move(slot->buf));
                slot->buf = take_buffer(want);
            }
            int64_t got = 0;
            while (got < want) {
                const ssize_t r = pread(fd, slot->buf.data.get() + got,
                                        static_cast<size_t>(want - got),
                                        data_offset + pos * bytes_per_spec + got);
                if (r < 0) {
                    std::lock_guard<std::mutex> lk(m);
                    io_error = true;
                    cv_slot_full.notify_all();
                    return;
                }
                if (r == 0) break;  // truncated file: surface what we have
                got += r;
            }
            const int64_t nspec_read = got / bytes_per_spec;
            {
                std::lock_guard<std::mutex> lk(m);
                slot->start = pos;
                slot->nspec = nspec_read;
                slot->full = true;
                ++prod;
                cv_slot_full.notify_all();
            }
            if (nspec_read < n) break;  // short read = end of data
            pos += payload;
        }
        std::lock_guard<std::mutex> lk(m);
        eof = true;
        cv_slot_full.notify_all();
    }
};

}  // namespace

extern "C" {

void* pf_open(const char* path, int64_t data_offset, int64_t bytes_per_spec,
              int64_t total_spec, int64_t payload_spec, int64_t overlap_spec,
              int depth) {
    if (bytes_per_spec <= 0 || payload_spec <= 0 || depth < 1) return nullptr;
    const int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    auto* p = new Prefetcher();
    p->fd = fd;
    p->data_offset = data_offset;
    p->bytes_per_spec = bytes_per_spec;
    p->total_spec = total_spec;
    p->payload = payload_spec;
    p->overlap = overlap_spec;
    p->ring.resize(static_cast<size_t>(depth));
    p->th = std::thread([p] { p->reader_loop(); });
    return p;
}

int pf_acquire(void* handle, uint8_t** buf, int64_t* start, int64_t* nspec) {
    auto* p = static_cast<Prefetcher*>(handle);
    std::unique_lock<std::mutex> lk(p->m);
    p->cv_slot_full.wait(lk, [&] {
        return p->io_error || p->ring[p->cons % p->ring.size()].full ||
               (p->eof && p->cons == p->prod);
    });
    if (p->io_error) return -1;
    Slot& slot = p->ring[p->cons % p->ring.size()];
    if (!slot.full) return 0;  // eof drained
    *buf = slot.buf.data.get();
    *start = slot.start;
    *nspec = slot.nspec;
    return 1;
}

void pf_release(void* handle) {
    auto* p = static_cast<Prefetcher*>(handle);
    std::lock_guard<std::mutex> lk(p->m);
    Slot& slot = p->ring[p->cons % p->ring.size()];
    if (slot.full) {
        slot.full = false;
        ++p->cons;
        p->cv_slot_free.notify_all();
    }
}

void pf_close(void* handle) {
    auto* p = static_cast<Prefetcher*>(handle);
    {
        std::lock_guard<std::mutex> lk(p->m);
        p->stop = true;
        p->cv_slot_free.notify_all();
    }
    if (p->th.joinable()) p->th.join();
    close(p->fd);
    for (Slot& slot : p->ring) give_buffer(std::move(slot.buf));
    delete p;
}

}  // extern "C"
