"""XXH3-64 in pure Python (the standard library only).

The JAX package hashes token blocks with the ``xxhash`` package's
``xxh3_64`` (seed 1337). The machine that serves the port has no such
package, so the port carries its own copy of the algorithm, written from
the XXH3 specification (xxhash.h, v0.8): the 0, 1-3, 4-8, 9-16, 17-128,
129-240 and >240-byte paths, and the custom secret derived from a non-zero
seed for the long path. ``tests/test_torch_tokens.py`` holds it against
``xxhash.xxh3_64_intdigest`` for every length up to 1100 bytes.

All arithmetic is on Python ints masked to 64 bits.
"""
from __future__ import annotations

import struct
from functools import lru_cache

_M64 = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF

P32_1 = 0x9E3779B1
P32_2 = 0x85EBCA77
P32_3 = 0xC2B2AE3D
P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5
PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

K_SECRET = bytes((
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,
    0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,
    0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,
    0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,
    0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,
    0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,
    0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,
    0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,
    0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,
    0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,
    0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,
    0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,
    0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
))
_SECRET_SIZE_MIN = 136
_STRIPE = 64
_CONSUME_RATE = 8
_LASTACC_START = 7
_MERGEACCS_START = 11
_MID_START = 3
_MID_LAST = 17

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x2 = struct.Struct("<2Q").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from


def _avalanche64(h: int) -> int:
    """XXH64's final mix."""
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PRIME_MX1) & _M64
    return h ^ (h >> 32)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * PRIME_MX2) & _M64
    h ^= (h >> 35) + length
    h = (h * PRIME_MX2) & _M64
    return h ^ (h >> 28)


def _fold64(a: int, b: int) -> int:
    """Low 64 bits XOR high 64 bits of the 128-bit product."""
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _mix16(data: bytes, i: int, secret: bytes, s: int, seed: int) -> int:
    lo, hi = _u64x2(data, i)
    k0, k1 = _u64x2(secret, s)
    return _fold64(lo ^ ((k0 + seed) & _M64), hi ^ ((k1 - seed) & _M64))


def _len_0to16(data: bytes, n: int, sec: bytes, seed: int) -> int:
    if n > 8:
        bf1 = ((_u64(sec, 24)[0] ^ _u64(sec, 32)[0]) + seed) & _M64
        bf2 = ((_u64(sec, 40)[0] ^ _u64(sec, 48)[0]) - seed) & _M64
        lo = _u64(data, 0)[0] ^ bf1
        hi = _u64(data, n - 8)[0] ^ bf2
        acc = (n + _swap64(lo) + hi + _fold64(lo, hi)) & _M64
        return _avalanche(acc)
    if n >= 4:
        seed ^= _swap32(seed & _M32) << 32
        in1 = _u32(data, 0)[0]
        in2 = _u32(data, n - 4)[0]
        bf = ((_u64(sec, 8)[0] ^ _u64(sec, 16)[0]) - seed) & _M64
        return _rrmxmx((in2 + (in1 << 32)) ^ bf, n)
    if n:
        combined = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                    | (n << 8))
        bf = ((_u32(sec, 0)[0] ^ _u32(sec, 4)[0]) + seed) & _M64
        return _avalanche64(combined ^ bf)
    return _avalanche64(seed ^ _u64(sec, 56)[0] ^ _u64(sec, 64)[0])


def _len_17to128(data: bytes, n: int, sec: bytes, seed: int) -> int:
    acc = (n * P64_1) & _M64
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, sec, 96, seed)
                acc += _mix16(data, n - 64, sec, 112, seed)
            acc += _mix16(data, 32, sec, 64, seed)
            acc += _mix16(data, n - 48, sec, 80, seed)
        acc += _mix16(data, 16, sec, 32, seed)
        acc += _mix16(data, n - 32, sec, 48, seed)
    acc += _mix16(data, 0, sec, 0, seed)
    acc += _mix16(data, n - 16, sec, 16, seed)
    return _avalanche(acc & _M64)


def _len_129to240(data: bytes, n: int, sec: bytes, seed: int) -> int:
    acc = (n * P64_1) & _M64
    for i in range(8):
        acc += _mix16(data, 16 * i, sec, 16 * i, seed)
    acc = _avalanche(acc & _M64)
    acc_end = _mix16(data, n - 16, sec, _SECRET_SIZE_MIN - _MID_LAST, seed)
    for i in range(8, n // 16):
        acc_end += _mix16(data, 16 * i, sec, 16 * (i - 8) + _MID_START, seed)
    return _avalanche((acc + acc_end) & _M64)


def _accumulate_512(acc: list[int], data: bytes, i: int, sec: bytes,
                    s: int) -> None:
    """One 64-byte stripe into the eight accumulators: lane j adds its
    input word to lane j^1 and (key-mixed low32 x high32) to itself."""
    v0, v1, v2, v3, v4, v5, v6, v7 = _u64x8(data, i)
    k0, k1, k2, k3, k4, k5, k6, k7 = _u64x8(sec, s)
    k0 ^= v0
    k1 ^= v1
    k2 ^= v2
    k3 ^= v3
    k4 ^= v4
    k5 ^= v5
    k6 ^= v6
    k7 ^= v7
    a0, a1, a2, a3, a4, a5, a6, a7 = acc
    acc[0] = (a0 + v1 + (k0 & _M32) * (k0 >> 32)) & _M64
    acc[1] = (a1 + v0 + (k1 & _M32) * (k1 >> 32)) & _M64
    acc[2] = (a2 + v3 + (k2 & _M32) * (k2 >> 32)) & _M64
    acc[3] = (a3 + v2 + (k3 & _M32) * (k3 >> 32)) & _M64
    acc[4] = (a4 + v5 + (k4 & _M32) * (k4 >> 32)) & _M64
    acc[5] = (a5 + v4 + (k5 & _M32) * (k5 >> 32)) & _M64
    acc[6] = (a6 + v7 + (k6 & _M32) * (k6 >> 32)) & _M64
    acc[7] = (a7 + v6 + (k7 & _M32) * (k7 >> 32)) & _M64


def _scramble(acc: list[int], sec: bytes, s: int) -> None:
    keys = _u64x8(sec, s)
    for lane in range(8):
        a = acc[lane]
        a ^= a >> 47
        a ^= keys[lane]
        acc[lane] = (a * P32_1) & _M64


@lru_cache(maxsize=8)
def _custom_secret(seed: int) -> bytes:
    """The default secret with the seed added to (even words) and
    subtracted from (odd words) its 64-bit little-endian words."""
    words = struct.unpack("<24Q", K_SECRET)
    return struct.pack("<24Q", *(
        (w + seed) & _M64 if i % 2 == 0 else (w - seed) & _M64
        for i, w in enumerate(words)))


def _hash_long(data: bytes, n: int, sec: bytes) -> int:
    acc = [P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1]
    size = len(sec)
    stripes_per_block = (size - _STRIPE) // _CONSUME_RATE
    block = _STRIPE * stripes_per_block
    n_blocks = (n - 1) // block
    for b in range(n_blocks):
        for s in range(stripes_per_block):
            _accumulate_512(acc, data, b * block + s * _STRIPE, sec,
                            s * _CONSUME_RATE)
        _scramble(acc, sec, size - _STRIPE)
    n_stripes = ((n - 1) - block * n_blocks) // _STRIPE
    for s in range(n_stripes):
        _accumulate_512(acc, data, n_blocks * block + s * _STRIPE, sec,
                        s * _CONSUME_RATE)
    _accumulate_512(acc, data, n - _STRIPE, sec,
                    size - _STRIPE - _LASTACC_START)
    result = (n * P64_1) & _M64
    for i in range(4):
        k0, k1 = _u64x2(sec, _MERGEACCS_START + 16 * i)
        result += _fold64(acc[2 * i] ^ k0, acc[2 * i + 1] ^ k1)
    return _avalanche(result & _M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3 64-bit hash of ``data`` with a 64-bit ``seed``; the same value
    as ``xxhash.xxh3_64_intdigest(data, seed=seed)``."""
    seed &= _M64
    n = len(data)
    if n <= 16:
        return _len_0to16(data, n, K_SECRET, seed)
    if n <= 128:
        return _len_17to128(data, n, K_SECRET, seed)
    if n <= 240:
        return _len_129to240(data, n, K_SECRET, seed)
    return _hash_long(data, n, _custom_secret(seed) if seed else K_SECRET)
