// Wire codec for the TCP data plane: bf16<->fp32 payload conversion and a
// Castagnoli CRC-32C frame checksum.
//
// Role in the system: the reference serializes fp16 tensors into protobuf
// via hivemind's serializer backed by torch (+ its Go libp2p daemon); our
// multi-host transport (runtime/net.py) frames raw tensor bytes instead, and
// this small native library provides the two hot byte-level operations:
//   * halving the activation payload (fp32 host buffers -> bf16 wire bytes
//     and back) without round-tripping through numpy's scalar loops;
//   * integrity checksums per frame (WAN links corrupt; TCP's 16-bit
//     checksum is weak at these payload sizes).
// Python binds via ctypes (native/__init__.py) with a numpy fallback when
// the shared library has not been built.
//
// Build: make -C native   (g++ -O3 -shared; no external dependencies)

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// fp32 -> bf16 with round-to-nearest-even (matches XLA/TPU semantics).
void fp32_to_bf16(const float* src, uint16_t* dst, size_t n) {
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
  for (size_t i = 0; i < n; ++i) {
    uint32_t x = bits[i];
    // NaN: keep a quiet NaN mantissa, avoid rounding into infinity.
    if ((x & 0x7fffffffu) > 0x7f800000u) {
      dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040u);
      continue;
    }
    uint32_t rounding_bias = 0x7fffu + ((x >> 16) & 1u);
    dst[i] = static_cast<uint16_t>((x + rounding_bias) >> 16);
  }
}

// bf16 -> fp32 (exact).
void bf16_to_fp32(const uint16_t* src, float* dst, size_t n) {
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(src[i]) << 16;
  }
}

// CRC-32C (Castagnoli), slice-by-1 table, software implementation.
static uint32_t kCrcTable[256];
static bool table_init = false;

static void init_table() {
  const uint32_t poly = 0x82f63b78u;  // reversed Castagnoli polynomial
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1u) ? (poly ^ (c >> 1)) : (c >> 1);
    }
    kCrcTable[i] = c;
  }
  table_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  if (!table_init) init_table();
  uint32_t crc = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) {
    crc = kCrcTable[(crc ^ data[i]) & 0xffu] ^ (crc >> 8);
  }
  return crc ^ 0xffffffffu;
}

}  // extern "C"
