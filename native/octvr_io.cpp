// octvr_io — native frame IO + pipeline primitives for the stitcher.
//
// Role: the host-side runtime around the JAX compute path, mirroring the
// reference's C++ plumbing (vr::Queue<T> octvr.hpp:162-182, the
// AsyncMultiMapper buffer pool async.cpp:261-309, and the FFmpeg vr_map
// frame IO).  Exposed through a C ABI consumed via ctypes
// (octvr_tpu/runtime/native_io.py).
//
// Components:
//   * ovr_queue   — bounded MPMC blocking queue (mutex + condvars)
//   * ovr_pool    — recycling frame-buffer pool (avoids per-frame malloc)
//   * ovr_reader  — threaded raw YUV420P stream reader (file or pipe):
//                   reads fixed-size frames into pool buffers on a
//                   background thread and hands them out via the queue,
//                   so Python never blocks on disk/pipe IO
//   * ovr_writer  — buffered frame writer on its own thread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// ------------------------------------------------------------------ queue

struct ovr_queue {
    std::mutex m;
    std::condition_variable cv_push, cv_pop;
    std::deque<void*> items;
    size_t capacity;
    bool closed = false;
};

ovr_queue* ovr_queue_new(size_t capacity) {
    auto* q = new ovr_queue();
    q->capacity = capacity ? capacity : SIZE_MAX;
    return q;
}

// returns 0 on success, -1 if closed
int ovr_queue_push(ovr_queue* q, void* item) {
    std::unique_lock<std::mutex> lk(q->m);
    q->cv_push.wait(lk, [&] { return q->items.size() < q->capacity || q->closed; });
    if (q->closed) return -1;
    q->items.push_back(item);
    q->cv_pop.notify_one();
    return 0;
}

// returns item or nullptr if closed and drained
void* ovr_queue_pop(ovr_queue* q) {
    std::unique_lock<std::mutex> lk(q->m);
    q->cv_pop.wait(lk, [&] { return !q->items.empty() || q->closed; });
    if (q->items.empty()) return nullptr;
    void* it = q->items.front();
    q->items.pop_front();
    q->cv_push.notify_one();
    return it;
}

size_t ovr_queue_size(ovr_queue* q) {
    std::lock_guard<std::mutex> lk(q->m);
    return q->items.size();
}

void ovr_queue_close(ovr_queue* q) {
    std::lock_guard<std::mutex> lk(q->m);
    q->closed = true;
    q->cv_pop.notify_all();
    q->cv_push.notify_all();
}

void ovr_queue_free(ovr_queue* q) { delete q; }

// ------------------------------------------------------------------- pool

struct ovr_pool {
    std::mutex m;
    std::condition_variable cv;
    std::vector<uint8_t*> free_bufs;
    size_t buf_size;
    size_t total = 0, max_bufs;
};

ovr_pool* ovr_pool_new(size_t buf_size, size_t max_bufs) {
    auto* p = new ovr_pool();
    p->buf_size = buf_size;
    p->max_bufs = max_bufs ? max_bufs : 64;
    return p;
}

uint8_t* ovr_pool_acquire(ovr_pool* p) {
    std::unique_lock<std::mutex> lk(p->m);
    if (p->free_bufs.empty() && p->total < p->max_bufs) {
        p->total++;
        lk.unlock();
        return new uint8_t[p->buf_size];
    }
    p->cv.wait(lk, [&] { return !p->free_bufs.empty(); });
    uint8_t* b = p->free_bufs.back();
    p->free_bufs.pop_back();
    return b;
}

void ovr_pool_release(ovr_pool* p, uint8_t* buf) {
    std::lock_guard<std::mutex> lk(p->m);
    p->free_bufs.push_back(buf);
    p->cv.notify_one();
}

void ovr_pool_free(ovr_pool* p) {
    for (auto* b : p->free_bufs) delete[] b;
    delete p;
}

// ----------------------------------------------------------------- reader

struct ovr_frame {
    uint8_t* data;
    int64_t index;
};

struct ovr_reader {
    FILE* f;
    size_t frame_size;
    ovr_pool* pool;
    ovr_queue* q;
    std::thread th;
    std::atomic<bool> stop{false};
    int64_t count = 0;
};

static void reader_loop(ovr_reader* r) {
    while (!r->stop.load()) {
        uint8_t* buf = ovr_pool_acquire(r->pool);
        size_t got = fread(buf, 1, r->frame_size, r->f);
        if (got != r->frame_size) {
            ovr_pool_release(r->pool, buf);
            ovr_queue_close(r->q);
            return;
        }
        auto* fr = new ovr_frame{buf, r->count++};
        if (ovr_queue_push(r->q, fr) != 0) {
            ovr_pool_release(r->pool, buf);
            delete fr;
            return;
        }
    }
    ovr_queue_close(r->q);
}

// path may be "-" for stdin
ovr_reader* ovr_reader_open(const char* path, size_t frame_size, int depth) {
    FILE* f = (strcmp(path, "-") == 0) ? stdin : fopen(path, "rb");
    if (!f) return nullptr;
    auto* r = new ovr_reader();
    r->f = f;
    r->frame_size = frame_size;
    r->pool = ovr_pool_new(frame_size, depth + 2);
    r->q = ovr_queue_new(depth);
    r->th = std::thread(reader_loop, r);
    return r;
}

// copies the next frame into out; returns frame index >= 0, or -1 at EOF
int64_t ovr_reader_next(ovr_reader* r, uint8_t* out) {
    auto* fr = static_cast<ovr_frame*>(ovr_queue_pop(r->q));
    if (!fr) return -1;
    memcpy(out, fr->data, r->frame_size);
    int64_t idx = fr->index;
    ovr_pool_release(r->pool, fr->data);
    delete fr;
    return idx;
}

void ovr_reader_close(ovr_reader* r) {
    r->stop.store(true);
    ovr_queue_close(r->q);
    if (r->th.joinable()) r->th.join();
    // drain
    while (void* it = ovr_queue_pop(r->q)) {
        auto* fr = static_cast<ovr_frame*>(it);
        ovr_pool_release(r->pool, fr->data);
        delete fr;
    }
    if (r->f != stdin) fclose(r->f);
    ovr_queue_free(r->q);
    ovr_pool_free(r->pool);
    delete r;
}

// ----------------------------------------------------------------- writer

struct ovr_writer {
    FILE* f;
    size_t frame_size;
    ovr_pool* pool;
    ovr_queue* q;
    std::thread th;
};

static void writer_loop(ovr_writer* w) {
    while (void* it = ovr_queue_pop(w->q)) {
        uint8_t* buf = static_cast<uint8_t*>(it);
        fwrite(buf, 1, w->frame_size, w->f);
        ovr_pool_release(w->pool, buf);
    }
    fflush(w->f);
}

ovr_writer* ovr_writer_open(const char* path, size_t frame_size, int depth) {
    FILE* f = (strcmp(path, "-") == 0) ? stdout : fopen(path, "wb");
    if (!f) return nullptr;
    auto* w = new ovr_writer();
    w->f = f;
    w->frame_size = frame_size;
    w->pool = ovr_pool_new(frame_size, depth + 2);
    w->q = ovr_queue_new(depth);
    w->th = std::thread(writer_loop, w);
    return w;
}

void ovr_writer_push(ovr_writer* w, const uint8_t* data) {
    uint8_t* buf = ovr_pool_acquire(w->pool);
    memcpy(buf, data, w->frame_size);
    ovr_queue_push(w->q, buf);
}

void ovr_writer_close(ovr_writer* w) {
    ovr_queue_close(w->q);
    if (w->th.joinable()) w->th.join();
    if (w->f != stdout) fclose(w->f);
    ovr_queue_free(w->q);
    ovr_pool_free(w->pool);
    delete w;
}

}  // extern "C"
