// WebP decoding for the host data path (C ABI, loaded with ctypes).
//
// The pixels are those Pillow gives for `Image.open(path)`, bit for bit.
// Pillow decodes every WebP through libwebp's WebPAnimDecoder into
// non-premultiplied RGBA, with libwebp's defaults (fancy upsampling, no
// dithering); this file follows libwebp's decoder:
// - the RIFF container: simple lossy ("VP8 ") and lossless ("VP8L") files,
//   and extended ones ("VP8X") with ALPH, with ICCP, EXIF and XMP (skipped:
//   they do not change the pixels), and with ANIM / ANMF, of which the
//   first frame is drawn as WebPAnimDecoder draws it: onto a transparent
//   black canvas at twice its stored offsets, not blended (the first frame
//   is a key frame, and its disposal acts only before the next one);
// - VP8, the lossy key frame of RFC 6386: the boolean decoder, segments
//   and their quantizer and filter deltas, 1, 2, 4 or 8 token partitions,
//   the coefficient probabilities and their updates, dequantisation, the
//   inverse WHT and DCT, every intra mode with the edge samples libwebp
//   uses at the frame's borders, and the simple and normal loop filters
//   (inner edges skipped in a 16x16-predicted macroblock without
//   coefficients);
// - VP8L, the lossless format (see `Vp8l`);
// - ALPH: raw or VP8L-compressed, with its horizontal, vertical or gradient
//   filter undone;
// - YUV -> RGB: libwebp's 14-bit fixed-point conversion with its "fancy"
//   (9, 3, 3, 1) chroma upsampling, at odd sizes too.
// Refused with a message naming what was found: a VP8 frame that is not a
// key frame or not shown, a stream that ends early, a chunk that runs past
// the file's end, bad codes or headers.
//
// `webp_info` gives the canvas's width and height and its channels, 4
// where the file says it has alpha (Pillow's "RGBA") and 3 where it does
// not (Pillow's "RGB"); `webp_decode` then fills a caller-owned [H, W, C]
// uint8 buffer. Both return 0, or 1 with a message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// RFC 6386's tables: the 4x4 intra modes' probabilities by the modes above
// and to the left, the coefficient probabilities and their update
// probabilities, the DC and AC quantizer steps; and VP8L's distance map
// (dy << 4 | 8 - dx of each of the 120 short distance codes)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, in libwebp's numbering: the 16x16 and chroma modes are the
// first four
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
  B_HD_PRED, B_HU_PRED, NUM_BMODES,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  DC_NOTOP = NUM_BMODES, DC_NOLEFT, DC_NOTOPLEFT
};
// the 4x4 mode tree: a negative entry is a leaf (minus the mode)
const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6,
                                  -B_HE_PRED, 5, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7,
                                  -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

inline uint8_t clip8b(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// ------------------------------------------------ the boolean decoder
//
// RFC 6386 section 7 in libwebp's form (range kept minus one, bytes loaded
// one at a time). Past the end it feeds one zero byte and marks the stream
// ended, as libwebp does: a partition whose reader ended is truncated.
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    p_ = p;
    end_ = p + n;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int get(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(value_ >> pos);
    int bit;
    if (value > split) {
      range -= split;
      value_ -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= get(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = value(nbits);
    return get(0x80) ? -v : v;
  }

 private:
  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 0;
  int bits_ = 0;
  bool eof_ = false;

  void load() {
    if (p_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *p_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
};

// ------------------------------------------------------------------- VP8
//
// A key frame (RFC 6386) decoded to its Y, U and V planes, padded to whole
// macroblocks, in libwebp's order: the first partition's modes a row at a
// time, the residuals from the row's token partition, the row predicted
// from the unfiltered pixels above and to the left (127 above the frame,
// 129 left of it) and reconstructed; then the loop filter over the frame,
// macroblock by macroblock in raster order, as libwebp filters each row
// once it is reconstructed.

constexpr int BPS = 32;  // the work buffer's stride (libwebp's yuv_b_)
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8b(top[x] + l - tl);
    dst += BPS;
  }
}

void fill_block(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 luma and 8x8 chroma: DC (with its edge variants), TM, V, H
void predict_block(uint8_t* dst, int mode, int size) {
  const int log2 = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, dc >> (log2 + 1), size);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, dc >> log2, size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill_block(dst, dc >> log2, size);
      break;
    }
    case DC_NOTOPLEFT: fill_block(dst, 0x80, size); break;
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    default: fail("VP8: bad intra mode");
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS];
  const int A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                               (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default: fail("VP8: bad 4x4 intra mode");
  }
}
#undef DST

// the inverse DCT of one 4x4 block, added to the prediction (libwebp's
// TransformOne: a vertical pass, then a horizontal one with +4 >> 3)
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip8b(row[0] + ((a + d) >> 3));
    row[1] = clip8b(row[1] + ((b + c) >> 3));
    row[2] = clip8b(row[2] + ((b - c) >> 3));
    row[3] = clip8b(row[3] + ((a - d) >> 3));
  }
}

// the inverse Walsh-Hadamard transform of the 16 luma DCs, into each
// block's coefficient 0
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------------ the loop filter
inline int sclip1(int v) { return clamp(v, -128, 127); }
inline int sclip2(int v) { return clamp(v, -16, 15); }

inline void filter2(uint8_t* p, int step) {  // 4 pixels in, 2 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {  // 4 pixels in, 4 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8b(p1 + a3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {  // 6 pixels in, 6 out
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8b(p2 + a3);
  p[-2 * step] = clip8b(p1 + a2);
  p[-step] = clip8b(p0 + a1);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a2);
  p[2 * step] = clip8b(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// the simple filter along 16 pixels of one edge: `step` across the edge,
// `along` between the edge's pixels
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, t2)) filter2(p, step);
}
// the normal filter along `size` pixels: a macroblock edge (filter6) or an
// inner edge (filter4), filter2 where the edge has high variance
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_thresh)) {
      filter2(p, step);
    } else if (mb_edge) {
      filter6(p, step);
    } else {
      filter4(p, step);
    }
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  int uvmode = 0, segment = 0;
  bool is_i4x4 = false, skip = false;
};

class Vp8 {
 public:
  int width = 0, height = 0;
  int mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // [mb_h*16][mb_w*16], [mb_h*8][mb_w*8] twice

  Vp8(const uint8_t* p, size_t n) : p_(p), n_(n) {
    if (n < 10) fail("VP8: frame header truncated");
    const uint32_t bits = p[0] | (p[1] << 8) | (p[2] << 16);
    if (bits & 1) fail("VP8: not a key frame (an inter frame does not decode on its own)");
    const int profile = (bits >> 1) & 7;
    if (profile > 3) fail("VP8: profile " + std::to_string(profile) + " is not defined");
    if (!((bits >> 4) & 1)) fail("VP8: a frame that is not shown");
    part0_size_ = bits >> 5;
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail("VP8: bad key frame start code");
    width = (p[6] | (p[7] << 8)) & 0x3fff;
    height = (p[8] | (p[9] << 8)) & 0x3fff;
    if (!width || !height) fail("VP8: frame of size 0");
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
  }

  void decode() {
    const uint8_t* buf = p_ + 10;
    size_t size = n_ - 10;
    if (part0_size_ > size) fail("VP8: first partition runs past the frame (truncated)");
    br_.init(buf, part0_size_);
    buf += part0_size_;
    size -= part0_size_;
    br_.get(0x80);  // colour space
    br_.get(0x80);  // clamping type: libwebp always clamps
    parse_segment_header();
    parse_filter_header();
    if (br_.eof()) fail("VP8: frame header truncated");
    parse_partitions(buf, size);
    parse_quant();
    br_.get(0x80);  // refresh the probabilities: ignored on a key frame
    parse_proba();

    const int ys = mb_w * 16, uvs = mb_w * 8;
    y.assign((size_t)ys * mb_h * 16, 0);
    u.assign((size_t)uvs * mb_h * 8, 0);
    v.assign((size_t)uvs * mb_h * 8, 0);
    intra_t_.assign(4 * (size_t)mb_w, B_DC_PRED);
    nz_.assign(mb_w, 0);
    nz_dc_.assign(mb_w, 0);
    top_y_.assign(16 * (size_t)mb_w, 0);
    top_u_.assign(8 * (size_t)mb_w, 0);
    top_v_.assign(8 * (size_t)mb_w, 0);
    finfo_.assign((size_t)mb_w * mb_h, FInfo());
    mbd_.assign(mb_w, MBData());
    precompute_filter_strengths();
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
      if (br_.eof()) fail("VP8: the first partition ends early (truncated)");
      left_nz_ = left_nz_dc_ = 0;
      BoolReader& tokens = parts_[mb_y & (num_parts_ - 1)];
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        decode_mb(mb_x, mb_y, tokens);
        if (tokens.eof()) fail("VP8: a token partition ends early (truncated)");
      }
      reconstruct_row(mb_y);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y);
  }

 private:
  const uint8_t* p_;
  size_t n_;
  uint32_t part0_size_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_ = 1;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {}, filter_strength_[4] = {};
  int seg_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
  FInfo fstrengths_[4][2];
  // quantizers: [segment] y1 (dc, ac), y2, uv
  int dq_[4][3][2] = {};
  uint8_t proba_[4][8][3][11] = {};
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  // decoding state
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4] = {};
  std::vector<uint8_t> nz_, nz_dc_;
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<MBData> mbd_;
  std::vector<FInfo> finfo_;
  std::vector<uint8_t> top_y_, top_u_, top_v_;
  uint8_t yuv_b_[YUV_SIZE] = {};

  void parse_segment_header() {
    use_segment_ = br_.get(0x80);
    if (use_segment_) {
      update_map_ = br_.get(0x80);
      if (br_.get(0x80)) {  // update the segments' data
        absolute_delta_ = br_.get(0x80);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.get(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.get(0x80) ? br_.value(8) : 255;
    } else {
      update_map_ = false;
    }
  }

  void parse_filter_header() {
    simple_ = br_.get(0x80);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.get(0x80);
    if (use_lf_delta_ && br_.get(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    const int last = (1 << br_.value(2)) - 1;
    num_parts_ = last + 1;
    if (size < 3 * (size_t)last) fail("VP8: partition sizes truncated");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (int p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= buf + size) fail("VP8: the last token partition is empty (truncated)");
  }

  void parse_quant() {
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.get(0x80) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.get(0x80) ? br_.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        std::memcpy(dq_[i], dq_[0], sizeof(dq_[0]));
        continue;
      } else {
        q = base_q0;
      }
      int(*m)[2] = dq_[i];
      m[0][0] = kDcTable[clamp(q + dqy1_dc, 0, 127)];
      m[0][1] = kAcTable[clamp(q, 0, 127)];
      m[1][0] = kDcTable[clamp(q + dqy2_dc, 0, 127)] * 2;
      // x * 155 / 100, as (x * 101581) >> 16
      m[1][1] = (kAcTable[clamp(q + dqy2_ac, 0, 127)] * 101581) >> 16;
      if (m[1][1] < 8) m[1][1] = 8;
      m[2][0] = kDcTable[clamp(q + dquv_dc, 0, 117)];
      m[2][1] = kAcTable[clamp(q + dquv_ac, 0, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = (uint8_t)(br_.get(kCoeffsUpdateProba[t][b][c][p])
                                               ? br_.value(8)
                                               : kCoeffsProba0[t][b][c][p]);
    use_skip_proba_ = br_.get(0x80);
    if (use_skip_proba_) skip_p_ = br_.value(8);
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = clamp(level, 0, 63);
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;  // no filtering
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x) {
    MBData& b = mbd_[mb_x];
    if (update_map_) {
      b.segment = !br_.get(seg_proba_[0]) ? br_.get(seg_proba_[1]) : br_.get(seg_proba_[2]) + 2;
    } else {
      b.segment = 0;
    }
    b.skip = use_skip_proba_ ? br_.get(skip_p_) : 0;
    b.is_i4x4 = !br_.get(145);
    uint8_t* top = &intra_t_[4 * (size_t)mb_x];
    if (!b.is_i4x4) {
      const int ymode = br_.get(156) ? (br_.get(128) ? TM_PRED : H_PRED)
                                     : (br_.get(163) ? V_PRED : DC_PRED);
      b.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(intra_l_, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = intra_l_[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.get(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.get(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        intra_l_[y] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br_.get(142) ? DC_PRED : !br_.get(114) ? V_PRED : br_.get(183) ? TM_PRED : H_PRED;
  }

  // one block's tokens from position n on → the index past its last
  // non-zero coefficient (libwebp's GetCoeffs), dequantised into `out`
  int get_coeffs(BoolReader& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get(p[0])) return n;  // the previous coefficient was the last non-zero one
      while (!br.get(p[1])) {       // a run of zeros
        if (++n == 16) return 16;
        p = proba_[type][kBands[n]][0];
      }
      const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.get(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = large_value(br, p);
        p = p_ctx[2];
      }
      const int s = br.get(0x80) ? -v : v;
      out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
    }
    return 16;
  }

  static int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.get(p[3])) {
      v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
    } else if (!br.get(p[6])) {
      if (!br.get(p[7])) {
        v = 5 + br.get(159);
      } else {
        v = 7 + 2 * br.get(165);
        v += br.get(145);
      }
    } else {
      const int bit1 = br.get(p[8]);
      const int bit0 = br.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // the residuals of one macroblock (libwebp's ParseResiduals) → whether
  // all its coefficients are zero
  bool parse_residuals(int mb_x, BoolReader& br) {
    MBData& b = mbd_[mb_x];
    const int(*q)[2] = dq_[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    bool any = false;
    int first, ac_type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {};
      const int ctx = nz_dc_[mb_x] + left_nz_dc_;
      const int nz = get_coeffs(br, 1, ctx, q[1], 0, dc);
      nz_dc_[mb_x] = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      for (int i = 0; i < 256; i += 16) any |= dst[i] != 0;
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = nz_[mb_x] & 0x0f;
    uint8_t lnz = left_nz_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q[0], first, dst);
        l = nz > first;
        any |= nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = (uint8_t)(nz_[mb_x] >> (4 + ch));
      lnz = (uint8_t)(left_nz_ >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q[2], 0, dst);
          l = nz > 0;
          any |= nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      out_t |= (uint32_t)(tnz << 4) << ch;
      out_l |= (uint32_t)(lnz & 0xf0) << ch;
    }
    nz_[mb_x] = (uint8_t)out_t;
    left_nz_ = (uint8_t)out_l;
    return !any;
  }

  void decode_mb(int mb_x, int mb_y, BoolReader& br) {
    MBData& b = mbd_[mb_x];
    bool skip = use_skip_proba_ ? b.skip : false;
    if (!skip) {
      skip = parse_residuals(mb_x, br);
    } else {
      left_nz_ = nz_[mb_x] = 0;
      if (!b.is_i4x4) left_nz_dc_ = nz_dc_[mb_x] = 0;
      std::memset(b.coeffs, 0, sizeof(b.coeffs));
    }
    if (filter_type_ > 0) {
      FInfo& f = finfo_[(size_t)mb_y * mb_w + mb_x];
      f = fstrengths_[b.segment][b.is_i4x4];
      f.inner = f.inner || !skip;
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
  }

  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = yuv_b_ + Y_OFF;
    uint8_t* const u_dst = yuv_b_ + U_OFF;
    uint8_t* const v_dst = yuv_b_ + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    const int ys = mb_w * 16, uvs = mb_w * 8;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& b = mbd_[mb_x];
      if (mb_x > 0) {  // the left samples from the previous macroblock
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* ty = &top_y_[16 * (size_t)mb_x];
      uint8_t* tu = &top_u_[8 * (size_t)mb_x];
      uint8_t* tv = &top_v_[8 * (size_t)mb_x];
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, ty, 16);
        std::memcpy(u_dst - BPS, tu, 8);
        std::memcpy(v_dst - BPS, tv, 8);
      }
      if (b.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            std::memset(top_right, ty[15], 4);
          } else {
            std::memcpy(top_right, ty + 16, 4);
          }
        }
        // the top-right pixels stand in for the right column's blocks too
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n >> 2) * 4 * BPS + (n & 3) * 4;
          predict4(dst, b.imodes[n]);
          idct_add(b.coeffs + n * 16, dst);
        }
      } else {
        predict_block(y_dst, check_mode(mb_x, mb_y, b.imodes[0]), 16);
        for (int n = 0; n < 16; ++n)
          idct_add(b.coeffs + n * 16, y_dst + (n >> 2) * 4 * BPS + (n & 3) * 4);
      }
      const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
      predict_block(u_dst, uvmode, 8);
      predict_block(v_dst, uvmode, 8);
      for (int n = 0; n < 4; ++n) {
        const int off = (n >> 1) * 4 * BPS + (n & 1) * 4;
        idct_add(b.coeffs + (16 + n) * 16, u_dst + off);
        idct_add(b.coeffs + (20 + n) * 16, v_dst + off);
      }
      // the unfiltered bottom rows: the next row's top samples
      std::memcpy(ty, y_dst + 15 * BPS, 16);
      std::memcpy(tu, u_dst + 7 * BPS, 8);
      std::memcpy(tv, v_dst + 7 * BPS, 8);
      for (int j = 0; j < 16; ++j)
        std::memcpy(&y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&u[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&v[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  void filter_mb(int mb_x, int mb_y) {
    const FInfo& f = finfo_[(size_t)mb_y * mb_w + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = mb_w * 16, uvs = mb_w * 8;
    uint8_t* yp = &y[(size_t)mb_y * 16 * ys + mb_x * 16];
    if (filter_type_ == 1) {  // simple: luma only
      if (mb_x > 0) simple_edge(yp, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(yp, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* up = &u[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* vp = &v[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, ht = f.hev_thresh;
    if (mb_x > 0) {
      normal_edge(yp, 1, ys, 16, limit + 4, il, ht, true);
      normal_edge(up, 1, uvs, 8, limit + 4, il, ht, true);
      normal_edge(vp, 1, uvs, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) normal_edge(yp + 4 * k, 1, ys, 16, limit, il, ht, false);
      normal_edge(up + 4, 1, uvs, 8, limit, il, ht, false);
      normal_edge(vp + 4, 1, uvs, 8, limit, il, ht, false);
    }
    if (mb_y > 0) {
      normal_edge(yp, ys, 1, 16, limit + 4, il, ht, true);
      normal_edge(up, uvs, 1, 8, limit + 4, il, ht, true);
      normal_edge(vp, uvs, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        normal_edge(yp + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
      normal_edge(up + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
      normal_edge(vp + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    }
  }
};

// ------------------------------------------------------- YUV -> RGB
//
// libwebp's conversion (dsp/yuv.h): 14-bit constants, products taken
// >> 8, the sum rounded down from 6 fraction bits and clipped.
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t clip_yuv(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One pair of output rows from their luma rows and the chroma rows above
// (`tu`, `tv`) and below (`cu`, `cv`) them: libwebp's "fancy" upsampler,
// the (9, 3, 3, 1) / 16 weights as its two roundings give them. `bot_y` is
// null for a row of its own (the first, and the last of an even height),
// then called with the same chroma row above and below.
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu,
                   const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst,
                   uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl[2] = {tu[0], tv[0]}, l[2] = {cu[0], cv[0]};
  {
    int uv[2];
    for (int c = 0; c < 2; ++c) uv[c] = (3 * tl[c] + l[c] + 2) >> 2;
    yuv_to_rgb(top_y[0], uv[0], uv[1], top_dst);
    if (bot_y) {
      for (int c = 0; c < 2; ++c) uv[c] = (3 * l[c] + tl[c] + 2) >> 2;
      yuv_to_rgb(bot_y[0], uv[0], uv[1], bot_dst);
    }
  }
  for (int x = 1; x <= last_pair; ++x) {
    const int t[2] = {tu[x], tv[x]}, c_[2] = {cu[x], cv[x]};
    int d12[2], d03[2];
    for (int c = 0; c < 2; ++c) {
      const int avg = tl[c] + t[c] + l[c] + c_[c] + 8;
      d12[c] = (avg + 2 * (t[c] + l[c])) >> 3;
      d03[c] = (avg + 2 * (tl[c] + c_[c])) >> 3;
    }
    yuv_to_rgb(top_y[2 * x - 1], (d12[0] + tl[0]) >> 1, (d12[1] + tl[1]) >> 1,
               top_dst + 4 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03[0] + t[0]) >> 1, (d03[1] + t[1]) >> 1, top_dst + 4 * (2 * x));
    if (bot_y) {
      yuv_to_rgb(bot_y[2 * x - 1], (d03[0] + l[0]) >> 1, (d03[1] + l[1]) >> 1,
                 bot_dst + 4 * (2 * x - 1));
      yuv_to_rgb(bot_y[2 * x], (d12[0] + c_[0]) >> 1, (d12[1] + c_[1]) >> 1,
                 bot_dst + 4 * (2 * x));
    }
    for (int c = 0; c < 2; ++c) {
      tl[c] = t[c];
      l[c] = c_[c];
    }
  }
  if (!(len & 1)) {
    int uv[2];
    for (int c = 0; c < 2; ++c) uv[c] = (3 * tl[c] + l[c] + 2) >> 2;
    yuv_to_rgb(top_y[len - 1], uv[0], uv[1], top_dst + 4 * (len - 1));
    if (bot_y) {
      for (int c = 0; c < 2; ++c) uv[c] = (3 * l[c] + tl[c] + 2) >> 2;
      yuv_to_rgb(bot_y[len - 1], uv[0], uv[1], bot_dst + 4 * (len - 1));
    }
  }
}

// the decoded frame's planes → rgba [height][width][4] (alpha left as it
// is), rows as libwebp's EmitFancyRGB pairs them: row 0 alone, then
// (1, 2), (3, 4), ..., and the last row alone where the height is even
void emit_rgb(const Vp8& d, uint8_t* rgba) {
  const int w = d.width, h = d.height, ys = d.mb_w * 16, uvs = d.mb_w * 8;
  const uint8_t *Y = d.y.data(), *U = d.u.data(), *V = d.v.data();
  const size_t stride = 4 * (size_t)w;
  upsample_pair(Y, nullptr, U, V, U, V, rgba, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const size_t t = (size_t)(y >> 1) * uvs, c = t + uvs;
    upsample_pair(Y + (size_t)(y + 1) * ys, Y + (size_t)(y + 2) * ys, U + t, V + t, U + c, V + c,
                  rgba + (y + 1) * stride, rgba + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const size_t c = (size_t)(y >> 1) * uvs;
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, U + c, V + c, U + c, V + c,
                  rgba + (h - 1) * stride, nullptr, w);
  }
}

// ------------------------------------------------------------------ VP8L
//
// The lossless format (libwebp's vp8l_dec.c): bits read least significant
// first; canonical Huffman codes, in the simple form (one or two symbols)
// or from code lengths coded with the 19-symbol code-length code; a
// meta-Huffman image choosing a group of five codes per tile; the colour
// cache; LZ77 copies with the 120-entry distance map; and the four
// transforms undone in reverse order of reading.

class LBits {
 public:
  LBits(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  uint32_t read(int nbits) {
    fill();
    const uint32_t v = (uint32_t)(val_ & ((1ull << nbits) - 1));
    skip(nbits);
    return v;
  }
  uint32_t peek() {
    fill();
    return (uint32_t)val_;
  }
  void skip(int nbits) {
    val_ >>= nbits;
    nbits_ -= nbits;
    consumed_ += (size_t)nbits;
  }
  bool eos() const { return consumed_ > 8 * n_; }

 private:
  const uint8_t* p_;
  size_t n_, pos_ = 0, consumed_ = 0;
  uint64_t val_ = 0;
  int nbits_ = 0;
  void fill() {
    while (nbits_ <= 56) {
      const uint64_t b = pos_ < n_ ? p_[pos_] : 0;
      ++pos_;
      val_ |= b << nbits_;
      nbits_ += 8;
    }
  }
};

struct Huffman {
  int single = -1;  // a code of one symbol: read with no bits
  int count[16] = {};
  std::vector<uint16_t> sorted;  // symbols by length, then by value
  uint16_t table[256] = {};      // 8 bits ahead: length << 12 | symbol, 0 = longer

  // libwebp's VP8LBuildHuffmanTable checks: a code must be complete, or of
  // one symbol
  bool build(const int* lengths, int n) {
    single = -1;
    std::memset(count, 0, sizeof(count));
    std::memset(table, 0, sizeof(table));
    int used = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
      used += lengths[s] > 0;
    }
    if (used == 0) return false;
    sorted.clear();
    for (int len = 1; len <= 15; ++len)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == len) sorted.push_back((uint16_t)s);
    if (used == 1) {
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = 2 * open - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int i = 0; i < count[len]; ++i, ++code, ++k) {
        if (len > 8) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < 256; j += 1 << len)
          table[j] = (uint16_t)((len << 12) | sorted[k]);
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek();
    if (const uint16_t e = table[bits & 255]) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      if (code - count[len] < first) {
        br.skip(len);
        return sorted[index + (code - first)];
      }
      index += count[len];
      first = (first + count[len]) << 1;
      code <<= 1;
    }
    fail("VP8L: bad Huffman code");
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) d += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip8b((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                            (int)((c2 >> s) & 0xff))
           << s;
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= (uint32_t)clip8b(a + (a - b) / 2) << s;  // C's division, toward zero
  }
  return out;
}
// the predictor of mode `m` from the left pixel and the row above (`top`
// points at the pixel above; top[1] past the row's end is the current row's
// first pixel, as libwebp reads it)
inline uint32_t predict_px(int m, uint32_t left, const uint32_t* top) {
  switch (m) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_px(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(average2(left, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
  }
}
inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class Vp8l {
 public:
  Vp8l(const uint8_t* p, size_t n) : br_(p, n) {}

  // The image header of a "VP8L" chunk → width, height, alpha_is_used.
  static void header(const uint8_t* p, size_t n, int* w, int* h, bool* alpha) {
    if (n < 5 || p[0] != 0x2f) fail("VP8L: bad signature");
    const uint32_t bits = p[1] | (p[2] << 8) | (p[3] << 16) | ((uint32_t)p[4] << 24);
    *w = (int)(bits & 0x3fff) + 1;
    *h = (int)((bits >> 14) & 0x3fff) + 1;
    *alpha = (bits >> 28) & 1;
    if (bits >> 29) fail("VP8L: version " + std::to_string(bits >> 29) + " is not defined");
  }

  // A whole "VP8L" chunk → ARGB pixels
  std::vector<uint32_t> decode_image(int w, int h) {
    br_.read(8);
    br_.read(32);
    return decode_stream(w, h, true);
  }

  // An image stream at `xsize` x `ysize`: with transforms and a meta-Huffman
  // image at the top level, without them for the images those carry.
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int tx = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br_.read(1)) {
        Transform t;
        t.type = (int)br_.read(2);
        if (seen & (1u << t.type)) fail("VP8L: a transform used twice");
        seen |= 1u << t.type;
        t.xsize = tx;
        t.ysize = ysize;
        if (t.type == 0 || t.type == 1) {  // predictor, cross colour
          t.bits = (int)br_.read(3) + 2;
          t.data = decode_stream(subsample(tx, t.bits), subsample(ysize, t.bits), false);
        } else if (t.type == 3) {  // colour indexing
          const int num_colors = (int)br_.read(8) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
          t.data.assign((size_t)1 << (8 >> t.bits), 0);  // past the palette: transparent black
          t.data[0] = pal[0];
          for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
          tx = subsample(tx, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = (int)br_.read(4);
      if (cache_bits < 1 || cache_bits > 11)
        fail("VP8L: colour cache of " + std::to_string(cache_bits) + " bits");
    }
    // the Huffman groups, and the image that picks one per tile
    std::vector<uint32_t> meta;
    int meta_bits = 0, meta_xsize = 0, num_groups = 1;
    if (level0 && br_.read(1)) {
      meta_bits = (int)br_.read(3) + 2;
      meta_xsize = subsample(tx, meta_bits);
      meta = decode_stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)m + 1);
      }
    }
    std::vector<Huffman> groups((size_t)num_groups * 5);
    std::vector<int> lengths(kAlphabetSize[0] + (1 << 11));
    for (int g = 0; g < num_groups; ++g)
      for (int j = 0; j < 5; ++j) {
        int size = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) size += 1 << cache_bits;
        read_code(size, lengths.data(), groups[(size_t)g * 5 + j]);
      }
    if (br_.eos()) fail("VP8L: the stream ends early (truncated)");
    std::vector<uint32_t> px = decode_pixels(tx, ysize, cache_bits, groups, meta, meta_bits,
                                             meta_xsize);
    for (int i = (int)transforms.size() - 1; i >= 0; --i) px = inverse(transforms[i], px);
    return px;
  }

  bool eos() const { return br_.eos(); }

 private:
  LBits br_;

  void read_code(int alphabet, int* lengths, Huffman& h) {
    std::fill(lengths, lengths + alphabet, 0);
    if (br_.read(1)) {  // simple: one or two symbols of length 1
      const int num = (int)br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      int s = (int)br_.read(first_bits);
      if (s < alphabet) lengths[s] = 1;
      if (num == 2) {
        s = (int)br_.read(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      int cl_lengths[19] = {};
      const int num_codes = (int)br_.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br_.read(3);
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) fail("VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * (int)br_.read(3);
        max_symbol = 2 + (int)br_.read(nbits);
        if (max_symbol > alphabet) fail("VP8L: bad code lengths");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        const int code = cl.read(br_);
        if (code < 16) {
          lengths[s++] = code;
          if (code) prev = code;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int repeat = (int)br_.read(extra[code - 16]) + offset[code - 16];
          if (s + repeat > alphabet) fail("VP8L: bad code lengths");
          const int len = code == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = len;
        }
      }
    }
    if (br_.eos()) fail("VP8L: the stream ends early (truncated)");
    if (!h.build(lengths, alphabet)) fail("VP8L: bad Huffman code");
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + (int)br_.read(extra) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dc = kCodeToPlane[code - 1];
    const int dist = (dc >> 4) * xsize + (8 - (dc & 0xf));
    return dist >= 1 ? dist : 1;
  }

  std::vector<uint32_t> decode_pixels(int w, int h, int cache_bits,
                                      const std::vector<Huffman>& groups,
                                      const std::vector<uint32_t>& meta, int meta_bits,
                                      int meta_xsize) {
    const size_t total = (size_t)w * h;
    std::vector<uint32_t> out(total);
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    const int shift = 32 - cache_bits;
    auto insert = [&](uint32_t px) {
      if (cache_bits) cache[(0x1e35a7bdu * px) >> shift] = px;
    };
    size_t i = 0;
    int col = 0, row = 0;
    while (i < total) {
      const Huffman* g = &groups[meta_bits ? (size_t)meta[(size_t)(row >> meta_bits) * meta_xsize +
                                                          (col >> meta_bits)] * 5
                                           : 0];
      const int code = g[0].read(br_);
      if (code < 256) {
        const uint32_t r = g[1].read(br_), b = g[2].read(br_), a = g[3].read(br_);
        out[i] = (a << 24) | (r << 16) | ((uint32_t)code << 8) | b;
        insert(out[i++]);
        if (++col >= w) {
          col = 0;
          ++row;
          if (br_.eos()) break;
        }
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dist = plane_distance(w, copy_value(g[4].read(br_)));
        if (br_.eos()) break;
        if (i < (size_t)dist || total - i < (size_t)length)
          fail("VP8L: a backward reference outside the image");
        for (int k = 0; k < length; ++k, ++i) {
          out[i] = out[i - dist];
          insert(out[i]);
        }
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else {
        const size_t key = (size_t)(code - 280);
        if (key >= cache.size()) fail("VP8L: a colour cache code without a cache");
        out[i] = cache[key];
        insert(out[i++]);
        if (++col >= w) {
          col = 0;
          ++row;
          if (br_.eos()) break;
        }
      }
    }
    if (br_.eos()) fail("VP8L: the stream ends early (truncated)");
    return out;
  }

  static std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // subtract green
      for (uint32_t& p : in) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
                       r2b = (int8_t)((m >> 16) & 0xff);
          uint32_t& p = in[(size_t)y * w + x];
          const int8_t green = (int8_t)(p >> 8);
          int r = (p >> 16) & 0xff, b = p & 0xff;
          r = (r + color_delta(g2r, green)) & 0xff;
          b = (b + color_delta(g2b, green) + color_delta(r2b, (int8_t)r)) & 0xff;
          p = (p & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
        }
      return std::move(in);
    }
    if (t.type == 0) {  // predictor: in place, each pixel its residual plus the prediction
      uint32_t* px = in.data();
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      const int tiles = subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = px + (size_t)y * w;
        const uint32_t* top = row - w;
        const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < w; ++x) {
          const int m = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict_px(m, row[x - 1], top + x));
        }
      }
      return std::move(in);
    }
    // colour indexing: indices packed 1, 2, 4 or 8 a pixel in the green byte
    const int bits_per_pixel = 8 >> t.bits;
    const int per_byte = 1 << t.bits;
    const int iw = subsample(w, t.bits);
    std::vector<uint32_t> out((size_t)w * h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = &in[(size_t)y * iw];
      uint32_t* dst = &out[(size_t)y * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & ((1u << bits_per_pixel) - 1)];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------- ALPH
//
// The alpha plane of a lossy frame: raw or VP8L-compressed (its green
// channel), then undone row by row from its filter (none, horizontal,
// vertical, gradient), as libwebp's unfilters do it.
std::vector<uint8_t> decode_alpha(const uint8_t* p, size_t n, int w, int h) {
  if (n < 1) fail("ALPH: empty chunk");
  const int method = p[0] & 3, filter = (p[0] >> 2) & 3, pre = (p[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (p[0] >> 6))
    fail("ALPH: header byte " + std::to_string(p[0]) + " is not defined");
  const size_t size = (size_t)w * h;
  std::vector<uint8_t> a(size);
  if (method == 0) {
    if (n - 1 < size) fail("ALPH: raw alpha shorter than the frame (truncated)");
    std::memcpy(a.data(), p + 1, size);
  } else {
    Vp8l l(p + 1, n - 1);
    const std::vector<uint32_t> argb = l.decode_stream(w, h, true);
    for (size_t i = 0; i < size; ++i) a[i] = (uint8_t)(argb[i] >> 8);
  }
  if (filter == 0) return a;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = &a[(size_t)y * w];
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 1 || !prev) {  // horizontal, and the first row of the others
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        left = (uint8_t)(row[x] + clip8b(left + top - top_left));
        top_left = top;
        row[x] = left;
      }
    }
  }
  return a;
}

// ----------------------------------------------------------- container
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

struct Chunk {
  char tag[5] = {};
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t padded = 0;  // with the padding byte, where the file holds it
};

// the chunks between `pos` and `end`, each padded to an even size
std::vector<Chunk> chunks(const uint8_t* p, size_t pos, size_t end) {
  std::vector<Chunk> out;
  while (pos + 8 <= end) {
    Chunk c;
    std::memcpy(c.tag, p + pos, 4);
    c.size = le32(p + pos + 4);
    if (c.size > end - pos - 8)
      fail(std::string("WebP: chunk '") + c.tag + "' runs past the file's end (truncated)");
    c.data = p + pos + 8;
    c.padded = std::min(c.size + (c.size & 1), end - pos - 8);
    out.push_back(c);
    pos += 8 + c.size + (c.size & 1);
  }
  return out;
}

struct Frame {
  const uint8_t* alph = nullptr;
  size_t alph_n = 0;
  const uint8_t* bits = nullptr;
  size_t bits_n = 0;
  bool lossless = false;
  bool vp8l_alpha = false;  // a VP8L header's alpha_is_used
  int x0 = 0, y0 = 0, w = 0, h = 0;
};

// the image's bitstream chunks: ALPH (kept for a lossy one), then VP8 or
// VP8L; others skipped. The bitstream runs to the end of its padded chunk,
// as libwebp's demuxer hands it to the decoder.
Frame frame_of(const std::vector<Chunk>& cs) {
  Frame f;
  for (const Chunk& c : cs) {
    if (!std::memcmp(c.tag, "ALPH", 4) && !f.alph) {
      f.alph = c.data;
      f.alph_n = c.size;
    } else if (!std::memcmp(c.tag, "VP8 ", 4) || !std::memcmp(c.tag, "VP8L", 4)) {
      f.bits = c.data;
      f.bits_n = c.padded;
      f.lossless = c.tag[3] == 'L';
      break;
    }
  }
  if (!f.bits) fail("WebP: no VP8 or VP8L image data");
  if (f.lossless) f.alph = nullptr;  // libwebp ignores ALPH beside VP8L
  if (f.lossless) {
    Vp8l::header(f.bits, f.bits_n, &f.w, &f.h, &f.vp8l_alpha);
  } else {
    const Vp8 d(f.bits, f.bits_n);
    f.w = d.width;
    f.h = d.height;
  }
  return f;
}

struct WebP {
  int width = 0, height = 0;
  bool alpha = false;
  Frame frame;

  WebP(const uint8_t* p, size_t n) {
    if (n < 12 || std::memcmp(p, "RIFF", 4) || std::memcmp(p + 8, "WEBP", 4))
      fail("not a WebP file");
    const size_t end = 8 + (size_t)le32(p + 4);
    if (end > n) fail("WebP: RIFF size past the file's end (truncated)");
    const std::vector<Chunk> cs = chunks(p, 12, end);
    if (cs.empty()) fail("WebP: no chunks");
    const Chunk& first = cs[0];
    if (!std::memcmp(first.tag, "VP8 ", 4) || !std::memcmp(first.tag, "VP8L", 4)) {
      frame = frame_of(cs);
      width = frame.w;
      height = frame.h;
      alpha = frame.vp8l_alpha;
      return;
    }
    if (std::memcmp(first.tag, "VP8X", 4) || first.size < 10)
      fail(std::string("WebP: first chunk '") + first.tag + "' is not VP8, VP8L or VP8X");
    const int flags = first.data[0];
    alpha = flags & 0x10;
    width = (int)le24(first.data + 4) + 1;
    height = (int)le24(first.data + 7) + 1;
    const std::vector<Chunk> rest(cs.begin() + 1, cs.end());
    if (flags & 0x02) {  // an animation: its first frame
      const Chunk* anmf = nullptr;
      for (const Chunk& c : rest)
        if (!std::memcmp(c.tag, "ANMF", 4)) {
          anmf = &c;
          break;
        }
      if (!anmf) fail("WebP: an animation without frames");
      if (anmf->size < 16) fail("WebP: ANMF chunk truncated");
      const uint8_t* a = anmf->data;
      const int x0 = 2 * (int)le24(a), y0 = 2 * (int)le24(a + 3);
      const int w = (int)le24(a + 6) + 1, h = (int)le24(a + 9) + 1;
      frame = frame_of(chunks(a, 16, anmf->size));
      if (frame.w != w || frame.h != h)
        fail("WebP: an ANMF frame of " + std::to_string(w) + "x" + std::to_string(h) +
             " holds an image of " + std::to_string(frame.w) + "x" + std::to_string(frame.h));
      frame.x0 = x0;
      frame.y0 = y0;
    } else {
      frame = frame_of(rest);
      if (frame.w != width || frame.h != height)
        fail("WebP: canvas of " + std::to_string(width) + "x" + std::to_string(height) +
             " holds an image of " + std::to_string(frame.w) + "x" + std::to_string(frame.h));
    }
    if (frame.x0 + frame.w > width || frame.y0 + frame.h > height)
      fail("WebP: the first frame lies outside the canvas");
  }

  // out: [height][width][alpha ? 4 : 3]
  void decode(uint8_t* out) const {
    const Frame& f = frame;
    std::vector<uint8_t> rgba((size_t)f.w * f.h * 4);
    if (f.lossless) {
      Vp8l l(f.bits, f.bits_n);
      const std::vector<uint32_t> argb = l.decode_image(f.w, f.h);
      for (size_t i = 0; i < argb.size(); ++i) {
        rgba[4 * i] = (uint8_t)(argb[i] >> 16);
        rgba[4 * i + 1] = (uint8_t)(argb[i] >> 8);
        rgba[4 * i + 2] = (uint8_t)argb[i];
        rgba[4 * i + 3] = (uint8_t)(argb[i] >> 24);
      }
    } else {
      Vp8 d(f.bits, f.bits_n);
      d.decode();
      emit_rgb(d, rgba.data());
      if (f.alph) {
        const std::vector<uint8_t> a = decode_alpha(f.alph, f.alph_n, f.w, f.h);
        for (size_t i = 0; i < a.size(); ++i) rgba[4 * i + 3] = a[i];
      } else {
        for (size_t i = 0; i < (size_t)f.w * f.h; ++i) rgba[4 * i + 3] = 255;
      }
    }
    // onto the canvas: transparent black where the frame does not reach
    const int ch = alpha ? 4 : 3;
    std::memset(out, 0, (size_t)width * height * ch);
    for (int y = 0; y < f.h; ++y)
      for (int x = 0; x < f.w; ++x)
        std::memcpy(out + ((size_t)(f.y0 + y) * width + f.x0 + x) * ch,
                    &rgba[((size_t)y * f.w + x) * 4], ch);
  }
};

int report(const Error& e, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", e.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

// The canvas's width, height and channels: 4 where the file has alpha
// (Pillow's "RGBA"), else 3.
int webp_info(const uint8_t* data, size_t n, int* w, int* h, int* c, char* err, int err_len) {
  try {
    const WebP f(data, n);
    *w = f.width;
    *h = f.height;
    *c = f.alpha ? 4 : 3;
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

// Decode into out [h, w, c] uint8 (the shape `webp_info` gave).
int webp_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int err_len) {
  try {
    WebP(data, n).decode(out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

}  // extern "C"
