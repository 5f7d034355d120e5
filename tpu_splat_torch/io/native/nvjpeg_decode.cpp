// JPEG decode through nvJPEG (CUDA toolkit) for the port's image loader.
//
// The JAX package decodes JPEG with libjpeg (tpu_splat/io/native/image_loader.cpp); the
// machines the port targets carry the CUDA toolkit, whose nvJPEG decodes on the card.
// Output is interleaved 8-bit RGB copied back to a host buffer; the resampling that
// follows is the port's numpy code (io/image.py), shared with PNG.
//
// Each calling thread (the dataloader's prefetch threads) keeps its own decoder state,
// device buffer and non-blocking stream for the life of the process: no cudaMalloc or
// cudaFree per image, whose implicit device synchronisation would stall training.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 nvjpeg_decode.cpp -I$CUDA/include
//        -L$CUDA/lib64 -lnvjpeg -lcudart   (io/nvjpeg.py does this at first use)

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_init = NVJPEG_STATUS_NOT_INITIALIZED;
std::once_flag g_once;

struct ThreadDecoder {
    nvjpegJpegState_t state = nullptr;
    cudaStream_t stream = nullptr;
    unsigned char* dbuf = nullptr;
    size_t cap = 0;
    ~ThreadDecoder() {
        if (dbuf) cudaFree(dbuf);
        if (stream) cudaStreamDestroy(stream);
        if (state) nvjpegJpegStateDestroy(state);
    }
};

thread_local ThreadDecoder t_dec;

int init() {
    std::call_once(g_once, [] { g_init = nvjpegCreateSimple(&g_handle); });
    if (g_init != NVJPEG_STATUS_SUCCESS) return 100 + static_cast<int>(g_init);
    if (!t_dec.state) {
        nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &t_dec.state);
        if (s != NVJPEG_STATUS_SUCCESS) return 100 + static_cast<int>(s);
        if (cudaStreamCreateWithFlags(&t_dec.stream, cudaStreamNonBlocking) != cudaSuccess)
            return 3;
    }
    return 0;
}

}  // namespace

extern "C" {

// Image size from the JPEG header. Returns 0 on success.
int tpu_splat_jpeg_size(const unsigned char* data, size_t len, int* w, int* h) {
    int rc = init();
    if (rc) return rc;
    int n_comp = 0;
    nvjpegChromaSubsampling_t sub;
    int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, len, &n_comp, &sub, ws, hs);
    if (s != NVJPEG_STATUS_SUCCESS) return 100 + static_cast<int>(s);
    *w = ws[0];
    *h = hs[0];
    return 0;
}

// Decode into a host buffer of w * h * 3 bytes (interleaved RGB); w, h from
// tpu_splat_jpeg_size. Returns 0 on success.
int tpu_splat_jpeg_decode(const unsigned char* data, size_t len, unsigned char* out,
                          int w, int h) {
    int rc = init();
    if (rc) return rc;
    const size_t bytes = static_cast<size_t>(w) * h * 3;
    if (bytes > t_dec.cap) {
        if (t_dec.dbuf) cudaFree(t_dec.dbuf);
        t_dec.dbuf = nullptr;
        t_dec.cap = 0;
        if (cudaMalloc(&t_dec.dbuf, bytes) != cudaSuccess) return 4;
        t_dec.cap = bytes;
    }
    nvjpegImage_t img = {};
    img.channel[0] = t_dec.dbuf;
    img.pitch[0] = static_cast<size_t>(w) * 3;
    nvjpegStatus_t s = nvjpegDecode(g_handle, t_dec.state, data, len, NVJPEG_OUTPUT_RGBI,
                                    &img, t_dec.stream);
    if (s != NVJPEG_STATUS_SUCCESS) return 100 + static_cast<int>(s);
    if (cudaMemcpyAsync(out, t_dec.dbuf, bytes, cudaMemcpyDeviceToHost, t_dec.stream) !=
        cudaSuccess)
        return 5;
    if (cudaStreamSynchronize(t_dec.stream) != cudaSuccess) return 6;
    return 0;
}

}  // extern "C"
