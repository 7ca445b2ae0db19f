"""LZ4 block-format decoder in plain Python, written from the public
format description (lz4_Block_format.md): a sequence is a token (literal
length in the high nibble, match length - 4 in the low nibble, each
extended by 255-runs), the literals, then a little-endian u16 offset; the
last sequence carries literals only.  The reference decoder of the
benchmark uses it, so it shares no code with the program's native coder."""

from __future__ import annotations


def decode(src: bytes, size: int) -> bytes:
    """Decompress one LZ4 block of ``size`` output bytes; raises
    ValueError on a malformed stream."""
    src = memoryview(src)
    n = len(src)
    out = bytearray()
    ip = 0
    while ip < n:
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n:
            raise ValueError("LZ4 literals run past the stream")
        out += src[ip:ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ValueError("LZ4 match offset outside the output")
        if mlen <= offset:
            out += out[start:start + mlen]
        else:
            pattern = out[start:]
            reps, rest = divmod(mlen, offset)
            out += pattern * reps + pattern[:rest]
    if len(out) != size:
        raise ValueError(f"LZ4 stream decodes to {len(out)} bytes, "
                         f"expected {size}")
    return bytes(out)
