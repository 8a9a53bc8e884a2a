"""PIZ (wavelet + Huffman) EXR compression codec, from the format spec.

Implements the OpenEXR PIZ scheme so the reader/writer in io/exr.py can
consume what production pipelines emit (the reference reads EXRs through
the Rust `exr` crate, which supports PIZ; ref:
lib/rust/mmimage/src/lib.rs:39,64).  The three stages follow the
published algorithms exactly:

  1. bitmap / lookup-table compaction of the used 16-bit values
     (ImfPizCompressor.cpp bitmapFromData / forwardLutFromBitmap /
     reverseLutFromBitmap semantics),
  2. a 2D integer wavelet transform per channel lattice, 14-bit fast
     path and 16-bit modular path (ImfWav.cpp wav2Encode/wav2Decode
     semantics),
  3. canonical Huffman coding over the whole chunk with a run-length
     pseudo-symbol (ImfHuf.cpp semantics: 6-bit packed code-length
     table with zero-run codes 59-63, canonical code assignment,
     14-bit fast decode table + long-code lists).

The wavelet stage is NumPy-vectorized per level; the Huffman stages are
plain Python over the chunk's symbols (a PIZ chunk is 32 scanlines).

Float channels contribute two 16-bit lattices each (size = bytes/2),
half channels one — identical to the reference pipeline's layout.

A copy of mayamatchmovesolver_tpu/io/_piz.py (host code, no tensors):
the port imports nothing of the JAX package.
"""

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN


class PizError(Exception):
    pass


# ---------------------------------------------------------------------------
# Stage 1: bitmap + LUT


def _bitmap_from_data(data):
    """Returns (bitmap bytes[BITMAP_SIZE], min_nonzero, max_nonzero)."""
    present = np.zeros(USHORT_RANGE, np.bool_)
    present[data] = True
    present[0] = False  # zero is always representable; not in bitmap
    bitmap = np.packbits(
        present.reshape(BITMAP_SIZE, 8)[:, ::-1], axis=1, bitorder="big"
    ).reshape(BITMAP_SIZE)
    nz = np.nonzero(bitmap)[0]
    if nz.size == 0:
        return bitmap, BITMAP_SIZE - 1, 0
    return bitmap, int(nz[0]), int(nz[-1])


def _forward_lut_from_bitmap(bitmap):
    """Returns (lut mapping value -> compact index, max_value)."""
    bits = np.unpackbits(bitmap, bitorder="little")[:USHORT_RANGE]
    present = bits.astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    k = np.cumsum(present) - 1
    lut[present] = k[present].astype(np.uint16)
    return lut, int(k[-1])


def _reverse_lut_from_bitmap(bitmap):
    """Returns (lut mapping compact index -> value, max_value)."""
    bits = np.unpackbits(bitmap, bitorder="little")[:USHORT_RANGE]
    present = bits.astype(bool)
    present[0] = True
    values = np.nonzero(present)[0].astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: values.size] = values
    return lut, int(values.size - 1)


# ---------------------------------------------------------------------------
# Stage 2: 2D wavelet (ImfWav.cpp semantics)

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wenc14(a, b):
    a_s = a.astype(np.int16).astype(np.int32)
    b_s = b.astype(np.int16).astype(np.int32)
    m = (a_s + b_s) >> 1
    d = a_s - b_s
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hi = h.astype(np.int16).astype(np.int32)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16)
    b = (ai - hi).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    b_i = b.astype(np.int32)
    m = (ao + b_i) >> 1
    d = ao - b_i
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d = d & _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_levels(nx, ny):
    n = min(nx, ny)
    levels = []
    p, p2 = 1, 2
    while p2 <= n:
        levels.append((p, p2))
        p, p2 = p2, p2 << 1
    return levels


def _wav2_encode(buf, max_value):
    """In-place 2D wavelet encode of a (ny, nx) uint16 lattice view."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = buf.shape
    for p, p2 in _wav2_levels(nx, ny):
        iy = np.arange(0, ny - p2 + 1, p2)
        ix = np.arange(0, nx - p2 + 1, p2)
        if iy.size and ix.size:
            yy, xx = np.ix_(iy, ix)
            a = buf[yy, xx]
            b = buf[yy, xx + p]
            c = buf[yy + p, xx]
            d = buf[yy + p, xx + p]
            i00, i01 = enc(a, b)
            i10, i11 = enc(c, d)
            l0, l1 = enc(i00, i10)
            h0, h1 = enc(i01, i11)
            buf[yy, xx] = l0
            buf[yy + p, xx] = l1
            buf[yy, xx + p] = h0
            buf[yy + p, xx + p] = h1
        if (nx & p) and iy.size:
            # leftover column: vertical-only transform
            x = ix[-1] + p2 if ix.size else 0
            l0, h0 = enc(buf[iy, x], buf[iy + p, x])
            buf[iy, x] = l0
            buf[iy + p, x] = h0
        if (ny & p) and ix.size:
            # leftover row: horizontal-only transform
            y = iy[-1] + p2 if iy.size else 0
            l0, h0 = enc(buf[y, ix], buf[y, ix + p])
            buf[y, ix] = l0
            buf[y, ix + p] = h0


def _wav2_decode(buf, max_value):
    """Inverse of _wav2_encode, levels unwound top-down."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = buf.shape
    for p, p2 in reversed(_wav2_levels(nx, ny)):
        iy = np.arange(0, ny - p2 + 1, p2)
        ix = np.arange(0, nx - p2 + 1, p2)
        if (ny & p) and ix.size:
            y = iy[-1] + p2 if iy.size else 0
            a, b = dec(buf[y, ix], buf[y, ix + p])
            buf[y, ix] = a
            buf[y, ix + p] = b
        if (nx & p) and iy.size:
            x = ix[-1] + p2 if ix.size else 0
            a, b = dec(buf[iy, x], buf[iy + p, x])
            buf[iy, x] = a
            buf[iy + p, x] = b
        if iy.size and ix.size:
            yy, xx = np.ix_(iy, ix)
            i00, i01 = dec(buf[yy, xx], buf[yy + p, xx])
            i10, i11 = dec(buf[yy, xx + p], buf[yy + p, xx + p])
            a, b = dec(i00, i10)
            c, d = dec(i01, i11)
            buf[yy, xx] = a
            buf[yy, xx + p] = b
            buf[yy + p, xx] = c
            buf[yy + p, xx + p] = d


# ---------------------------------------------------------------------------
# Stage 3: Huffman (ImfHuf.cpp semantics)


def _huf_canonical_code_table(lengths):
    """lengths: int array[HUF_ENCSIZE] of code lengths.  Returns codes
    array where entry = (code << 6) | length (the packed form the
    reference uses throughout)."""
    counts = np.bincount(lengths, minlength=59).astype(np.int64)
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + counts[i]) >> 1
        first[i] = c
        c = nc
    codes = np.zeros(HUF_ENCSIZE, np.int64)
    nxt = first.copy()
    idx = np.nonzero(lengths)[0]
    for i in idx:
        l = lengths[i]
        codes[i] = (int(nxt[l]) << 6) | int(l)
        nxt[l] += 1
    return codes


def _huf_build_enc_table(freq):
    """Build code-length table via the reference's heap merge; returns
    (codes packed, i_min, i_max) where i_max includes the appended
    run-length pseudo-symbol."""
    import heapq

    freq = freq.astype(np.int64).copy()
    nz = np.nonzero(freq)[0]
    if nz.size == 0:
        # Degenerate: only the pseudo-symbol exists.
        i_min = 0
        freq[0] = 1
        nz = np.array([0])
    else:
        i_min = int(nz[0])
    i_max = int(nz[-1]) + 1  # append run-length pseudo-symbol
    if i_max >= HUF_ENCSIZE:
        i_max = HUF_ENCSIZE - 1
    freq[i_max] = max(int(freq[i_max]), 0) + 1

    symbols = np.nonzero(freq)[0]
    hlink = {int(s): int(s) for s in symbols}  # chain next-pointers
    scode = np.zeros(HUF_ENCSIZE, np.int64)

    heap = [(int(freq[s]), int(s)) for s in symbols]
    heapq.heapify(heap)
    while len(heap) > 1:
        fm, mm = heapq.heappop(heap)  # smallest
        fM, m = heapq.heappop(heap)  # second smallest
        heapq.heappush(heap, (fm + fM, m))
        j = m
        while True:
            scode[j] += 1
            if scode[j] > 58:
                raise PizError("huffman code length overflow")
            if hlink[j] == j:
                hlink[j] = mm
                break
            j = hlink[j]
        j = mm
        while True:
            scode[j] += 1
            if scode[j] > 58:
                raise PizError("huffman code length overflow")
            if hlink[j] == j:
                break
            j = hlink[j]
    return _huf_canonical_code_table(scode), i_min, i_max


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits, value):
        self.c = (self.c << nbits) | (value & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def write_code(self, packed):
        self.write(packed & 63, packed >> 6)

    def flush(self):
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
        return bytes(self.out)


def _huf_pack_enc_table(codes, i_min, i_max):
    """6-bit code lengths with zero-run shortcuts (hufPackEncTable)."""
    w = _BitWriter()
    lengths = (codes & 63).astype(np.int64)
    i = i_min
    while i <= i_max:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while (i + zerun <= i_max and zerun < _LONGEST_LONG_RUN
                   and lengths[i + zerun] == 0):
                zerun += 1
            if zerun >= _SHORTEST_LONG_RUN:
                w.write(6, _LONG_ZEROCODE_RUN)
                w.write(8, zerun - _SHORTEST_LONG_RUN)
            elif zerun >= 2:
                w.write(6, _SHORT_ZEROCODE_RUN + zerun - 2)
            else:
                w.write(6, 0)
                zerun = 1
            i += zerun
        else:
            w.write(6, l)
            i += 1
    return w.flush()


class _BitReader:
    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def read(self, nbits):
        while self.lc < nbits:
            if self.pos >= len(self.data):
                raise PizError("unexpected end of huffman data")
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        v = (self.c >> self.lc) & ((1 << nbits) - 1)
        self.c &= (1 << self.lc) - 1
        return v


def _huf_unpack_enc_table(data, pos, i_min, i_max):
    """Inverse of _huf_pack_enc_table; returns (codes, end_pos)."""
    r = _BitReader(data, pos)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = i_min
    while i <= i_max:
        l = r.read(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = r.read(8) + _SHORTEST_LONG_RUN
            if i + zerun > i_max + 1:
                raise PizError("bad code-length table")
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            zerun = l - _SHORT_ZEROCODE_RUN + 2
            if i + zerun > i_max + 1:
                raise PizError("bad code-length table")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return _huf_canonical_code_table(lengths), r.pos


def _huf_encode(codes, data, rlc):
    """Run-length aware symbol encoding (hufEncode).  Returns
    (bytes, nbits)."""
    w = _BitWriter()
    code_len = codes & 63
    rlc_packed = int(codes[rlc])
    rlc_len = rlc_packed & 63

    def send(sym, run):
        packed = int(codes[sym])
        sl = packed & 63
        if sl == 0:
            raise PizError("symbol without code")
        if run and sl + rlc_len + 8 < sl * (run + 1):
            w.write_code(packed)
            w.write_code(rlc_packed)
            w.write(8, run)
        else:
            for _ in range(run + 1):
                w.write_code(packed)

    del code_len
    n = len(data)
    if n == 0:
        return b"", 0
    s = int(data[0])
    run = 0
    for i in range(1, n):
        v = int(data[i])
        if v == s and run < 255:
            run += 1
        else:
            send(s, run)
            s = v
            run = 0
    send(s, run)
    total_bits = len(w.out) * 8 + w.lc
    return w.flush(), total_bits


def _huf_build_dec_table(codes, i_min, i_max):
    """14-bit fast table + long-code lists (hufBuildDecTable)."""
    fast_len = np.zeros(HUF_DECSIZE, np.int32)
    fast_lit = np.zeros(HUF_DECSIZE, np.int64)
    longs = [None] * HUF_DECSIZE
    for sym in range(i_min, i_max + 1):
        packed = int(codes[sym])
        l = packed & 63
        code = packed >> 6
        if l == 0:
            continue
        if code >> l:
            raise PizError("invalid code table entry")
        if l > HUF_DECBITS:
            slot = code >> (l - HUF_DECBITS)
            if fast_len[slot]:
                raise PizError("invalid code table entry")
            if longs[slot] is None:
                longs[slot] = []
            longs[slot].append(sym)
        else:
            base = code << (HUF_DECBITS - l)
            for k in range(1 << (HUF_DECBITS - l)):
                slot = base + k
                if fast_len[slot] or longs[slot] is not None:
                    raise PizError("invalid code table entry")
                fast_len[slot] = l
                fast_lit[slot] = sym
    return fast_len, fast_lit, longs


def _huf_decode(codes, fast_len, fast_lit, longs, data, nbits, rlc,
                n_out):
    """hufDecode: MSB-first bit stream -> n_out symbols."""
    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    n_bytes = (nbits + 7) // 8
    pos = 0

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                if pos >= n_bytes:
                    raise PizError("truncated huffman data")
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > n_out:
                raise PizError("bad run length in huffman data")
            prev = out[oi - 1]
            out[oi: oi + cs] = prev
            oi += cs
        else:
            if oi >= n_out:
                raise PizError("too much huffman data")
            out[oi] = sym
            oi += 1

    while pos < n_bytes:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            slot = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            fl = int(fast_len[slot])
            if fl:
                lc -= fl
                c &= (1 << lc) - 1
                emit(int(fast_lit[slot]))
            else:
                lst = longs[slot]
                if not lst:
                    raise PizError("invalid huffman code")
                for sym in lst:
                    packed = int(codes[sym])
                    l = packed & 63
                    while lc < l and pos < n_bytes:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= l and (packed >> 6) == (
                            (c >> (lc - l)) & ((1 << l) - 1)):
                        lc -= l
                        c &= (1 << lc) - 1
                        emit(sym)
                        break
                else:
                    raise PizError("invalid huffman code")

    # Flush remaining bits (< HUF_DECBITS).
    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        slot = ((c << (HUF_DECBITS - lc)) & HUF_DECMASK)
        fl = int(fast_len[slot])
        if fl and fl <= lc:
            lc -= fl
            c &= (1 << lc) - 1
            emit(int(fast_lit[slot]))
        else:
            raise PizError("invalid huffman code (flush)")
    if oi != n_out:
        raise PizError("huffman output size mismatch: %d != %d"
                       % (oi, n_out))
    return out


def huf_compress(data, use_native=True):
    """data: uint16 array.  Returns the reference-layout blob:
    [im u32][iM u32][tableLength u32][nBits u32][future u32=0]
    [packed table][bit data].

    Prefers the C++ codec in native/libmmtpu_native.so (the per-symbol
    loops are the hot path for production-size chunks — the
    reference's equivalent lives in the Rust exr crate); the Python
    implementation below is the always-available fallback and the
    parity oracle."""
    if data.size == 0:
        return b""
    if use_native:
        blob = _native_huf_compress(data)
        if blob is not None:
            return blob
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    codes, i_min, i_max = _huf_build_enc_table(freq)
    table = _huf_pack_enc_table(codes, i_min, i_max)
    bits, nbits = _huf_encode(codes, data, i_max)
    header = struct.pack("<5I", i_min, i_max, len(table), nbits, 0)
    return header + table + bits


def huf_uncompress(blob, n_out, use_native=True):
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(blob) < 20:
        raise PizError("truncated huffman blob")
    if use_native:
        out = _native_huf_uncompress(blob, n_out)
        if out is not None:
            return out
    i_min, i_max, table_len, nbits, _ = struct.unpack_from("<5I", blob, 0)
    del table_len  # implied by the unpack walk, like the reference
    if i_min >= HUF_ENCSIZE or i_max >= HUF_ENCSIZE:
        raise PizError("bad huffman table range")
    codes, pos = _huf_unpack_enc_table(blob, 20, i_min, i_max)
    fast_len, fast_lit, longs = _huf_build_dec_table(codes, i_min, i_max)
    return _huf_decode(codes, fast_len, fast_lit, longs, blob[pos:],
                       nbits, i_max, n_out)


def _native_huf_compress(data):
    try:
        from mayamatchmovesolver_torch import native
    except ImportError:  # pragma: no cover
        return None
    return native.huf_compress(data)


def _native_huf_uncompress(blob, n_out):
    try:
        from mayamatchmovesolver_torch import native
    except ImportError:  # pragma: no cover
        return None
    try:
        return native.huf_uncompress(blob, n_out)
    except ValueError as e:
        raise PizError(str(e))


# ---------------------------------------------------------------------------
# PIZ chunk codec


def _channel_layout(channels, width, n_lines, type_size):
    """Per-channel (nx, ny, size_u16) for this chunk."""
    layout = []
    for c in channels:
        size = type_size[c["type"]] // 2
        layout.append((width, n_lines, size))
    return layout


def piz_compress(raw, channels, width, n_lines, type_size):
    """raw: scanline-block bytes (per line, channels in header order).
    Returns the PIZ chunk payload."""
    layout = _channel_layout(channels, width, n_lines, type_size)
    total_u16 = sum(nx * ny * s for nx, ny, s in layout)
    if len(raw) != total_u16 * 2:
        raise PizError("bad chunk size for PIZ compress")
    src = np.frombuffer(raw, "<u2")

    # Scanline-block -> per-channel contiguous buffers.
    bufs = [np.empty(ny * nx * s, np.uint16) for nx, ny, s in layout]
    pos = 0
    for line in range(n_lines):
        for ci, (nx, ny, s) in enumerate(layout):
            n = nx * s
            bufs[ci][line * n: (line + 1) * n] = src[pos: pos + n]
            pos += n

    tmp = np.concatenate(bufs) if bufs else np.zeros(0, np.uint16)
    bitmap, min_nz, max_nz = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut_from_bitmap(bitmap)
    tmp = lut[tmp]

    # Wavelet per channel lattice.
    off = 0
    for nx, ny, s in layout:
        n = nx * ny * s
        view = tmp[off: off + n]
        for j in range(s):
            lattice = view[j::s].reshape(ny, nx)
            _wav2_encode(lattice, max_value)
            view[j::s] = lattice.reshape(-1)
        off += n

    huf = huf_compress(tmp)
    out = struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz: max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf)) + huf
    return out


def piz_uncompress(payload, channels, width, n_lines, type_size):
    """Inverse of piz_compress; returns scanline-block bytes."""
    layout = _channel_layout(channels, width, n_lines, type_size)
    total_u16 = sum(nx * ny * s for nx, ny, s in layout)

    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz: max_nz + 1] = np.frombuffer(
            payload, np.uint8, n, pos
        )
        pos += n
    (huf_len,) = struct.unpack_from("<i", payload, pos)
    pos += 4
    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    tmp = huf_uncompress(payload[pos: pos + huf_len], total_u16)

    off = 0
    for nx, ny, s in layout:
        n = nx * ny * s
        view = tmp[off: off + n]
        for j in range(s):
            lattice = view[j::s].reshape(ny, nx).copy()
            _wav2_decode(lattice, max_value)
            view[j::s] = lattice.reshape(-1)
        off += n

    tmp = lut[tmp]

    # Per-channel buffers -> scanline-block layout.
    out = np.empty(total_u16, "<u2")
    pos = 0
    offs = np.cumsum([0] + [nx * ny * s for nx, ny, s in layout])
    for line in range(n_lines):
        for ci, (nx, ny, s) in enumerate(layout):
            n = nx * s
            out[pos: pos + n] = tmp[offs[ci] + line * n:
                                    offs[ci] + (line + 1) * n]
            pos += n
    return out.tobytes()
