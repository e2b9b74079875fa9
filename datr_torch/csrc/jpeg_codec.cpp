// JPEG decode and encode on the host, through libjpeg (the 6.2 ABI that
// libjpeg-turbo provides), for the HTTP front end (datr_torch/serve.py), the
// dataset reader (datr_torch/data/coco.py) and the serving bench's bodies.
//
// ctypes releases the GIL for the whole call, so concurrent handler threads
// decode in parallel. scale_num selects libjpeg's DCT-domain scaling
// (scale_num / 8, scale_num in 1..8): a decode straight to a reduced size
// costs roughly (scale_num / 8)^2 of the full one. At full scale the output
// is the baseline islow IDCT that PIL runs.
//
// Built with `g++ -O2 -shared -fPIC ... -ljpeg` at first use and loaded
// with ctypes (datr_torch/native.py).

#include <algorithm>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs size_t and FILE declared before it
#include <cstdlib>

#include <jpeglib.h>

namespace {

struct ErrorManager {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

// libjpeg's default error_exit calls exit(); jump back to the call instead
void error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorManager*>(cinfo->err)->jump, 1);
}

void emit_message(j_common_ptr, int) {}  // warnings stay silent

}  // namespace

extern "C" {

// Parse the header only. Returns 0 and fills (h, w), or nonzero where the
// input is no JPEG.
int jpeg_probe(const uint8_t* data, int64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to packed RGB uint8. out holds out_cap bytes, at least
// ceil(h * scale_num / 8) * ceil(w * scale_num / 8) * 3 for jpeg_probe's
// (h, w). Fills (out_h, out_w). Returns 0, or nonzero on a corrupt stream,
// an unsupported colour space or a short buffer.
int jpeg_decode_rgb(const uint8_t* data, int64_t len, int scale_num,
                    uint8_t* out, int64_t out_cap, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  volatile bool started = false;  // read after a longjmp
  if (setjmp(err.jump)) {
    if (started) jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // YCbCr / gray -> RGB in the decoder
  cinfo.scale_num = static_cast<unsigned>(std::clamp(scale_num, 1, 8));
  cinfo.scale_denom = 8;
  if (!jpeg_start_decompress(&cinfo)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  started = true;
  if (cinfo.output_components != 3 ||
      static_cast<int64_t>(cinfo.output_height) * cinfo.output_width * 3 >
          out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const int64_t stride = static_cast<int64_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  *out_h = static_cast<int>(cinfo.output_height);
  *out_w = static_cast<int>(cinfo.output_width);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode packed RGB uint8 [h, w, 3] at `quality` with libjpeg's defaults
// (YCbCr 4:2:0, islow DCT). On success returns 0 and a buffer from malloc in
// *out (*out_len bytes), which the caller releases with jpeg_free.
int jpeg_encode_rgb(const uint8_t* src, int h, int w, int quality,
                    unsigned char** out, unsigned long* out_len) {
  jpeg_compress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  *out = nullptr;
  *out_len = 0;
  if (setjmp(err.jump)) {
    // *out may name a buffer the destination has already replaced and
    // freed: drop it (the caller checks its arguments, so this is no path
    // of a valid call)
    jpeg_destroy_compress(&cinfo);
    *out = nullptr;
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out, out_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, std::clamp(quality, 1, 100), TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int64_t stride = static_cast<int64_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(src) + cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

void jpeg_free(unsigned char* buf) { std::free(buf); }

}  // extern "C"
