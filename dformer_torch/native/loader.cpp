// Native data-loader core of the port: threaded JPEG/PNG decode into
// caller-owned batch buffers, with a ring of in-flight batches (the port's
// own copy of the JAX package's loader; its C API is the same).
//
// The decode fan-out is a C++ thread pool inside the training process: no
// worker processes, no pickling, no Python in the decode path. Python
// (ctypes, dformer_torch/data/native_loader.py) submits filename batches and
// receives filled uint8 buffers, which go to the card, where the train
// augmentation runs (dformer_torch/data/augment.py).
//
// C API (all functions return 0 on success, negative on error):
//   dfl_create(num_threads) -> handle
//   dfl_destroy(handle)
//   dfl_decode_image(path, want_rgb, out_buf, out_cap, &h, &w, &c)
//   dfl_submit_batch(handle, paths[], n, want_rgb, itemH, itemW, itemC,
//                    out_buf)            // async: decodes n images of
//                                        // exactly (itemH, itemW, itemC)
//                                        // into out_buf; returns a ticket
//   dfl_wait_batch(handle, ticket)      // blocks until that submit is done
//
// Built at first use by dformer_torch/data/native_loader.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libdfloader.so -ljpeg -lpng

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// Color decodes emit cv2-native BGR channel order: the reference pipeline
// reads with cv2.imread and never converts (its COLOR_BGR2RGB argument is
// consumed as an imread flag), so reference checkpoints expect BGR pixels.
void swap_rb(uint8_t* buf, long npix) {
    for (long i = 0; i < npix; i++) {
        uint8_t t = buf[3 * i];
        buf[3 * i] = buf[3 * i + 2];
        buf[3 * i + 2] = t;
    }
}

// Decode a JPEG file to tightly packed BGR (or grayscale) uint8.
// Returns 0 on success.
int decode_jpeg(const char* path, bool want_rgb, uint8_t* out, long cap,
                int* h, int* w, int* c) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
    cinfo.out_color_space = want_rgb ? JCS_EXT_BGR : JCS_GRAYSCALE;
    const bool need_swap = false;
#else
    cinfo.out_color_space = want_rgb ? JCS_RGB : JCS_GRAYSCALE;
    const bool need_swap = want_rgb;
#endif
    jpeg_start_decompress(&cinfo);
    const int H = cinfo.output_height, W = cinfo.output_width,
              C = cinfo.output_components;
    if ((long)H * W * C > cap) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return -3;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + (long)cinfo.output_scanline * W * C;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    if (need_swap && C == 3) swap_rb(out, (long)H * W);
    *h = H; *w = W; *c = C;
    return 0;
}

// Decode a PNG file to packed uint8 (BGR or grayscale, 8-bit).
int decode_png(const char* path, bool want_rgb, uint8_t* out, long cap,
               int* h, int* w, int* c) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(f);
        return -2;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_set_strip_16(png);
    png_set_strip_alpha(png);
    png_set_palette_to_rgb(png);
    if (want_rgb) {
        png_set_gray_to_rgb(png);
        png_set_bgr(png);
    } else {
        if (png_get_color_type(png, info) & PNG_COLOR_MASK_COLOR)
            png_set_rgb_to_gray_fixed(png, 1, -1, -1);
    }
    png_read_update_info(png, info);
    const int H = png_get_image_height(png, info);
    const int W = png_get_image_width(png, info);
    const int C = png_get_channels(png, info);
    if ((long)H * W * C > cap) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(f);
        return -3;
    }
    std::vector<png_bytep> rows(H);
    for (int y = 0; y < H; y++) rows[y] = out + (long)y * W * C;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    *h = H; *w = W; *c = C;
    return 0;
}

int decode_any(const char* path, bool want_rgb, uint8_t* out, long cap,
               int* h, int* w, int* c) {
    const char* dot = strrchr(path, '.');
    if (dot && (!strcasecmp(dot, ".png"))) {
        return decode_png(path, want_rgb, out, cap, h, w, c);
    }
    return decode_jpeg(path, want_rgb, out, cap, h, w, c);
}

struct Pool {
    std::vector<std::thread> threads;
    std::queue<std::function<void()>> q;
    std::mutex m;
    std::condition_variable cv;
    bool stop = false;

    explicit Pool(int n) {
        for (int i = 0; i < n; i++) {
            threads.emplace_back([this] {
                for (;;) {
                    std::function<void()> job;
                    {
                        std::unique_lock<std::mutex> lk(m);
                        cv.wait(lk, [this] { return stop || !q.empty(); });
                        if (stop && q.empty()) return;
                        job = std::move(q.front());
                        q.pop();
                    }
                    job();
                }
            });
        }
    }

    ~Pool() {
        {
            std::lock_guard<std::mutex> lk(m);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : threads) t.join();
    }

    void submit(std::function<void()> job) {
        {
            std::lock_guard<std::mutex> lk(m);
            q.push(std::move(job));
        }
        cv.notify_one();
    }
};

struct Ticket {
    std::atomic<int> remaining{0};
    std::atomic<int> status{0};  // first error wins
    std::mutex m;
    std::condition_variable cv;
};

struct Loader {
    Pool pool;
    std::mutex tickets_m;
    std::vector<Ticket*> tickets;

    explicit Loader(int n) : pool(n) {}
    ~Loader() {
        for (auto* t : tickets) delete t;
    }
};

}  // namespace

extern "C" {

void* dfl_create(int num_threads) {
    return new Loader(num_threads > 0 ? num_threads : 2);
}

void dfl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int dfl_decode_image(const char* path, int want_rgb, uint8_t* out, long cap,
                     int* h, int* w, int* c) {
    return decode_any(path, want_rgb != 0, out, cap, h, w, c);
}

// Asynchronously decode n fixed-size images into out (n * H * W * C bytes,
// item i at offset i*H*W*C). Every image must decode to exactly (H, W, C)
// — dataset canvases are fixed per config. Returns a ticket id >= 0.
long dfl_submit_batch(void* handle, const char** paths, int n, int want_rgb,
                      int H, int W, int C, uint8_t* out) {
    auto* L = static_cast<Loader*>(handle);
    auto* t = new Ticket();
    t->remaining.store(n);
    long id;
    {
        std::lock_guard<std::mutex> lk(L->tickets_m);
        id = (long)L->tickets.size();
        L->tickets.push_back(t);
    }
    const long item = (long)H * W * C;
    for (int i = 0; i < n; i++) {
        std::string p(paths[i]);
        uint8_t* dst = out + (long)i * item;
        L->pool.submit([t, p, want_rgb, H, W, C, dst, item] {
            int h = 0, w = 0, c = 0;
            int rc = decode_any(p.c_str(), want_rgb != 0, dst, item, &h, &w, &c);
            if (rc == 0 && (h != H || w != W || c != C)) rc = -4;
            if (rc != 0) {
                int expected = 0;
                t->status.compare_exchange_strong(expected, rc);
            }
            if (t->remaining.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lk(t->m);
                t->cv.notify_all();
            }
        });
    }
    return id;
}

int dfl_wait_batch(void* handle, long ticket) {
    auto* L = static_cast<Loader*>(handle);
    Ticket* t;
    {
        std::lock_guard<std::mutex> lk(L->tickets_m);
        if (ticket < 0 || ticket >= (long)L->tickets.size()) return -10;
        t = L->tickets[ticket];
    }
    std::unique_lock<std::mutex> lk(t->m);
    t->cv.wait(lk, [t] { return t->remaining.load() == 0; });
    return t->status.load();
}

}  // extern "C"
