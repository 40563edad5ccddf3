// Native PNG -> RGB8 decoder for the host data pipeline (C ABI, loaded via ctypes).
//
// PNG decoding is lossless, so this produces pixels identical to PIL's decoder by
// construction; anything unusual (16-bit, interlaced handled via full read; decode
// errors) returns NULL and the Python side falls back to PIL.  JPEG is deliberately
// NOT handled here: JPEG decoders may differ in IDCT rounding, and the framework's
// parity guarantees (vs the reference's PIL loading) require byte-identical pixels.
//
// Build: g++ -O3 -shared -fPIC fastimage.cpp -lpng -o _fastimage.so
#include <png.h>

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {
// quiet handlers: the default ones print to stderr, which is noise from loader
// threads when we are about to fall back to PIL anyway
void quiet_error(png_structp png, png_const_charp) { png_longjmp(png, 1); }
void quiet_warning(png_structp, png_const_charp) {}
}  // namespace

extern "C" {

// Decode a PNG file to a malloc'd tightly-packed RGB8 buffer (h*w*3 bytes).
// Returns NULL on any failure; *w/*h are set on success. Caller frees with
// fastimage_free.
unsigned char *fastimage_decode_png_rgb8(const char *path, int *w, int *h) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) return nullptr;

  unsigned char sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return nullptr;
  }

  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           quiet_error, quiet_warning);
  if (!png) {
    std::fclose(fp);
    return nullptr;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return nullptr;
  }

  // volatile: both are written between setjmp and a potential longjmp, and the
  // handler must see the real values (no non-trivially-destructible locals may
  // live across the setjmp region either — rows is malloc'd, not a vector)
  unsigned char *volatile out = nullptr;
  png_bytep *volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {  // libpng error trampoline
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    std::free(rows);
    std::free(out);
    return nullptr;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (bit_depth == 16) {
    // PIL's I;16 -> RGB conversion clips to the low byte rather than taking the
    // high byte like png_set_strip_16 — punt 16-bit files to the PIL fallback so
    // pixels stay byte-identical
    longjmp(png_jmpbuf(png), 1);
  }
  // normalize every remaining PNG flavour to 8-bit RGB (matches PIL convert('RGB'))
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  if (png_get_rowbytes(png, info) != width * 3) {
    // transform chain should always land on RGB8; bail to the PIL fallback if not
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return nullptr;
  }

  out = static_cast<unsigned char *>(std::malloc(size_t(width) * height * 3));
  rows = static_cast<png_bytep *>(std::malloc(sizeof(png_bytep) * height));
  if (!out || !rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    std::free(rows);
    std::free(out);
    return nullptr;
  }
  for (png_uint_32 y = 0; y < height; ++y)
    rows[y] = out + size_t(y) * width * 3;
  png_read_image(png, const_cast<png_bytep *>(rows));
  png_read_end(png, nullptr);

  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  std::free(rows);
  *w = int(width);
  *h = int(height);
  return out;
}

void fastimage_free(unsigned char *buf) { std::free(buf); }

}  // extern "C"
