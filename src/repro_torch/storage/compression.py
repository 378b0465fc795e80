"""Pluggable chunk compression for the storage stack.

``zstandard`` gives the ratios/speeds the paper's storage numbers assume,
but it is an optional native dependency; environments without it fall back
to stdlib ``zlib``. Every on-store artifact records the codec it was
written with (SPAX footer, checkpoint manifest), so files stay readable
across environments as long as the writing codec is available — a zlib
reader never needs zstd to read zlib files.
"""

from __future__ import annotations

import zlib

try:
    import zstandard
    HAVE_ZSTD = True
except ImportError:          # pragma: no cover - environment-dependent
    zstandard = None
    HAVE_ZSTD = False

DEFAULT_CODEC = "zstd" if HAVE_ZSTD else "zlib"
CODECS = ("zstd", "zlib")


def compress(data: bytes, codec: str = DEFAULT_CODEC, *,
             level: int = 3) -> bytes:
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise RuntimeError("zstandard is not installed; "
                               "write with codec='zlib'")
        return zstandard.ZstdCompressor(level=level).compress(data)
    if codec == "zlib":
        return zlib.compress(data, min(level, 9))
    raise ValueError(f"unknown codec {codec!r} (expected one of {CODECS})")


def decompress(data: bytes, codec: str, *, max_output_size: int) -> bytes:
    cap = max(max_output_size, 1)
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise RuntimeError(
                "object was written with zstd but zstandard is not "
                "installed in this environment")
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=cap)
    if codec == "zlib":
        # bound the output like the zstd path: a corrupt chunk must
        # error, not balloon to arbitrary memory
        dobj = zlib.decompressobj()
        out = dobj.decompress(data, cap)
        if dobj.unconsumed_tail:
            raise ValueError(
                f"zlib chunk decompressed past its declared size ({cap})")
        return out
    raise ValueError(f"unknown codec {codec!r} (expected one of {CODECS})")
