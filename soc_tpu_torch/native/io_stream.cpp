// Native streaming IO for [CELLS, NFREQ] cell-frequency files.
//
// The reference streams absorbed.data through the solver in BATCH-cell
// chunks with synchronous fread (A2E.py:307-320); at 1e8+ cells the file is
// tens of GB and a Python-side read serializes against the solve. This
// module provides a double-buffered reader (a worker thread fills the next
// chunk while the caller consumes the current one) and a background writer,
// exposed through a plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread io_stream.cpp -o libsocio.so
// (soc_tpu_torch.native builds it on first use into soc_tpu_torch/_build/)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Reader {
    FILE* fp = nullptr;
    int64_t rows = 0;           // total rows (cells)
    int64_t cols = 0;           // floats per row
    int64_t batch = 0;          // rows per chunk
    int64_t next_row = 0;       // first row of the chunk being prefetched
    std::vector<float> buf[2];  // double buffer
    int64_t buf_rows[2] = {0, 0};
    int cur = 0;                // buffer ready for the consumer
    bool ready = false;
    bool done = false;
    std::thread worker;
    std::mutex m;
    std::condition_variable cv;

    void fill(int which) {
        int64_t want = rows - next_row;
        if (want > batch) want = batch;
        if (want <= 0) { buf_rows[which] = 0; return; }
        size_t n = fread(buf[which].data(), sizeof(float),
                         (size_t)(want * cols), fp);
        buf_rows[which] = (int64_t)(n / cols);
        next_row += buf_rows[which];
    }

    void run() {
        for (;;) {
            std::unique_lock<std::mutex> lk(m);
            cv.wait(lk, [&] { return !ready || done; });
            if (done) return;
            int nxt = cur ^ 1;
            lk.unlock();
            fill(nxt);
            lk.lock();
            cur = nxt;
            ready = true;
            if (buf_rows[nxt] == 0) done = true;
            cv.notify_all();
        }
    }
};

struct Writer {
    FILE* fp = nullptr;
    int64_t cols = 0;
    std::vector<float> pending;
    int64_t pending_rows = 0;
    bool has_pending = false;
    bool quit = false;
    std::thread worker;
    std::mutex m;
    std::condition_variable cv;

    void run() {
        for (;;) {
            std::unique_lock<std::mutex> lk(m);
            cv.wait(lk, [&] { return has_pending || quit; });
            if (has_pending) {
                std::vector<float> local;
                local.swap(pending);
                int64_t rows = pending_rows;
                has_pending = false;
                cv.notify_all();
                lk.unlock();
                fwrite(local.data(), sizeof(float),
                       (size_t)(rows * cols), fp);
                lk.lock();
            }
            if (quit && !has_pending) return;
        }
    }
};

}  // namespace

extern "C" {

// ---- reader ---------------------------------------------------------
void* socio_reader_open(const char* path, int64_t batch,
                        int64_t* rows, int64_t* cols) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    int32_t hdr[2];
    if (fread(hdr, sizeof(int32_t), 2, fp) != 2) { fclose(fp); return nullptr; }
    auto* r = new Reader();
    r->fp = fp;
    r->rows = hdr[0];
    r->cols = hdr[1];
    r->batch = batch;
    *rows = r->rows;
    *cols = r->cols;
    r->buf[0].resize((size_t)(batch * r->cols));
    r->buf[1].resize((size_t)(batch * r->cols));
    // prefetch the first chunk synchronously, then start the worker
    r->fill(0);
    r->cur = 0;
    r->ready = true;
    if (r->buf_rows[0] == 0) r->done = true;
    r->worker = std::thread(&Reader::run, r);
    return r;
}

// Copy the ready chunk into out (rows*cols floats); returns rows copied
// (0 = EOF) and immediately kicks off the prefetch of the next chunk.
int64_t socio_reader_next(void* h, float* out) {
    auto* r = static_cast<Reader*>(h);
    std::unique_lock<std::mutex> lk(r->m);
    r->cv.wait(lk, [&] { return r->ready || r->done; });
    if (!r->ready && r->done) return 0;
    int which = r->cur;
    int64_t got = r->buf_rows[which];
    if (got > 0)
        memcpy(out, r->buf[which].data(),
               (size_t)(got * r->cols) * sizeof(float));
    r->ready = false;           // hand the buffer back for prefetch
    r->cv.notify_all();
    return got;
}

void socio_reader_close(void* h) {
    auto* r = static_cast<Reader*>(h);
    {
        std::lock_guard<std::mutex> lk(r->m);
        r->done = true;
        r->ready = true;
    }
    r->cv.notify_all();
    if (r->worker.joinable()) r->worker.join();
    fclose(r->fp);
    delete r;
}

// ---- writer ---------------------------------------------------------
void* socio_writer_open(const char* path, int64_t rows, int64_t cols) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return nullptr;
    int32_t hdr[2] = {(int32_t)rows, (int32_t)cols};
    fwrite(hdr, sizeof(int32_t), 2, fp);
    auto* w = new Writer();
    w->fp = fp;
    w->cols = cols;
    w->worker = std::thread(&Writer::run, w);
    return w;
}

// Queue rows*cols floats for background writing (copies the data).
void socio_writer_put(void* h, const float* data, int64_t rows) {
    auto* w = static_cast<Writer*>(h);
    std::unique_lock<std::mutex> lk(w->m);
    w->cv.wait(lk, [&] { return !w->has_pending; });
    w->pending.assign(data, data + (size_t)(rows * w->cols));
    w->pending_rows = rows;
    w->has_pending = true;
    w->cv.notify_all();
}

void socio_writer_close(void* h) {
    auto* w = static_cast<Writer*>(h);
    {
        std::unique_lock<std::mutex> lk(w->m);
        w->cv.wait(lk, [&] { return !w->has_pending; });
        w->quit = true;
    }
    w->cv.notify_all();
    if (w->worker.joinable()) w->worker.join();
    fclose(w->fp);
    delete w;
}

}  // extern "C"
