"""OpenEXR scanline image I/O, implemented from the format spec.

Covers the reference's mmimage capability
(ref: lib/rust/mmimage/src/lib.rs:39,64,142 — read metadata, read
pixels as f32x4 RGBA, write f32x4 RGBA with metadata round-trip) without
external dependencies: single-part scanline EXRs, float32/half channels,
all eight non-deep OpenEXR compressions — NONE / RLE / ZIP / ZIPS /
PIZ (io/_piz.py, wavelet+Huffman) / PXR24 / B44 / B44A
(io/_pxr24_b44.py; PXR24 quantizes floats to 24 bits, B44 packs 4x4
half blocks to 14 bytes, B44A adds 3-byte flat blocks) — plus tiled
single-part and multi-part scanline reads.  Pixel transforms are
NumPy-vectorized.

A copy of mayamatchmovesolver_tpu/io/exr.py (host code, no tensors): the
port imports nothing of the JAX package.
"""

import struct
import zlib

import numpy as np

from mayamatchmovesolver_torch.io import _piz
from mayamatchmovesolver_torch.io import _pxr24_b44

_MAGIC = b"\x76\x2f\x31\x01"

# Channel pixel types.
_UINT, _HALF, _FLOAT = 0, 1, 2
_TYPE_SIZE = {_UINT: 4, _HALF: 2, _FLOAT: 4}
_TYPE_DTYPE = {
    _UINT: np.uint32,
    _HALF: np.float16,
    _FLOAT: np.float32,
}

COMPRESSION_NONE = 0
COMPRESSION_RLE = 1
COMPRESSION_ZIPS = 2
COMPRESSION_ZIP = 3
COMPRESSION_PIZ = 4
COMPRESSION_PXR24 = 5
COMPRESSION_B44 = 6
COMPRESSION_B44A = 7
_LINES_PER_CHUNK = {
    COMPRESSION_NONE: 1,
    COMPRESSION_RLE: 1,
    COMPRESSION_ZIPS: 1,
    COMPRESSION_ZIP: 16,
    COMPRESSION_PIZ: 32,
    COMPRESSION_PXR24: 16,
    COMPRESSION_B44: 32,
    COMPRESSION_B44A: 32,
}


class ExrError(Exception):
    pass


def _read_cstr(buf, pos):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data):
    channels = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        # int32 pixel type, uint8 pLinear, 3 reserved bytes, two int32
        # sampling rates = 16 bytes per channel entry.
        ptype, _plinear, xs, ys = struct.unpack_from("<iB3xii", data, pos)
        pos += 16
        channels.append({"name": name, "type": ptype,
                         "x_sampling": xs, "y_sampling": ys})
    return channels


def _pack_channels(channels):
    out = b""
    for ch in channels:
        out += ch["name"].encode("latin-1") + b"\0"
        out += struct.pack("<iB3xii", ch["type"], 0, 1, 1)
    return out + b"\0"


def read_header(file_path):
    """Read EXR attributes; returns dict name -> (type, raw bytes) plus
    parsed 'channels', 'dataWindow', 'compression'."""
    with open(file_path, "rb") as f:
        data = f.read()
    return _parse_header(data)[0]


def _parse_one_header(data, pos):
    """Parse one attribute block (ends at its null terminator)."""
    attrs = {}
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        atype, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = (atype, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    header = {"_attrs": attrs}
    if "channels" in attrs:
        header["channels"] = _parse_channels(attrs["channels"][1])
    if "dataWindow" in attrs:
        header["dataWindow"] = struct.unpack("<4i", attrs["dataWindow"][1])
    if "displayWindow" in attrs:
        header["displayWindow"] = struct.unpack(
            "<4i", attrs["displayWindow"][1]
        )
    if "compression" in attrs:
        header["compression"] = attrs["compression"][1][0]
    if "pixelAspectRatio" in attrs:
        header["pixelAspectRatio"] = struct.unpack(
            "<f", attrs["pixelAspectRatio"][1]
        )[0]
    if "tiles" in attrs:
        xs, ys, mode = struct.unpack("<IIB", attrs["tiles"][1])
        header["tiles"] = {
            "x_size": xs, "y_size": ys,
            "level_mode": mode & 0xF, "rounding_mode": mode >> 4,
        }
    if "name" in attrs:
        header["name"] = attrs["name"][1].decode("latin-1")
    if "type" in attrs:
        header["type"] = attrs["type"][1].decode("latin-1")
    if "chunkCount" in attrs:
        header["chunkCount"] = struct.unpack(
            "<i", attrs["chunkCount"][1]
        )[0]
    return header, pos


def _parse_header(data):
    """Single-part parse; returns (header, offset-table position).
    Raises on multi-part files (use _parse_multipart for those)."""
    if data[:4] != _MAGIC:
        raise ExrError("not an EXR file")
    version = struct.unpack_from("<i", data, 4)[0]
    if version & 0x1000:
        raise ExrError("multi-part EXR: use part-aware read")
    if version & 0x800:
        raise ExrError("deep EXR not supported")
    header, pos = _parse_one_header(data, 8)
    header["tiled"] = bool(version & 0x200)
    return header, pos


def _parse_multipart(data):
    """Multi-part parse; returns (headers list, first-offset-table
    position)."""
    if data[:4] != _MAGIC:
        raise ExrError("not an EXR file")
    version = struct.unpack_from("<i", data, 4)[0]
    if not version & 0x1000:
        header, pos = _parse_header(data)
        return [header], pos
    pos = 8
    headers = []
    while data[pos] != 0:
        header, pos = _parse_one_header(data, pos)
        headers.append(header)
    pos += 1  # empty header terminating the part list
    return headers, pos


def _predictor_decode(data):
    """Shared ZIP/RLE post-transform: predictor decode + de-interleave
    (ImfZip.cpp / ImfRleCompressor.cpp apply the identical reorder)."""
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    # EXR 'predictor' decode: rec[i] = rec[i-1] + d[i] - 128 (mod 256)
    # == (cumsum(d - 128) + 128) mod 256  (ImfZip.cpp semantics).
    rec = ((np.cumsum(arr - 128) + 128) % 256).astype(np.uint8)
    # De-interleave: first half -> even positions, second -> odd.
    n = len(rec)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _predictor_encode(raw):
    arr = np.frombuffer(raw, np.uint8)
    half = (len(arr) + 1) // 2
    del half
    # Interleave split.
    inter = np.concatenate([arr[0::2], arr[1::2]])
    # Delta encode with bias.
    delta = inter.astype(np.int16)
    delta[1:] = (delta[1:] - inter[:-1].astype(np.int16)) + 128
    return (delta % 256).astype(np.uint8).tobytes()


def _zip_decode(raw, expected_size):
    data = zlib.decompress(raw)
    if len(data) != expected_size:
        raise ExrError("bad chunk size after inflate")
    return _predictor_decode(data)


def _zip_encode(raw):
    return zlib.compress(_predictor_encode(raw), 6)


def _rle_uncompress(raw, expected_size):
    """EXR RLE record stream -> raw bytes (ImfRle.cpp rleUncompress):
    a signed count byte per record — negative = that many literal
    bytes follow; non-negative = repeat the next byte count+1 times."""
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n and len(out) < expected_size:
        count = raw[i]
        i += 1
        if count > 127:  # signed negative: literal run
            count = 256 - count
            out += raw[i:i + count]
            i += count
        else:
            out += raw[i:i + 1] * (count + 1)
            i += 1
    if len(out) != expected_size:
        raise ExrError("bad RLE chunk")
    return bytes(out)


def _rle_decode(raw, expected_size):
    return _predictor_decode(_rle_uncompress(raw, expected_size))


def _rle_encode(raw):
    """Predictor transform + RLE record stream (ImfRle.cpp rleCompress:
    runs of >= 3 become run records; literal stretches cap at 127)."""
    data = _predictor_encode(raw)
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        # Measure the run starting at i (cap at 128 repeats).
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        run = j - i + 1
        if run >= 3:
            out.append(run - 1)
            out.append(data[i])
            i = j + 1
            continue
        # Literal stretch until a run of >= 3 starts (cap at 127).
        start = i
        while i < n and i - start < 127:
            if (i + 2 < n and data[i] == data[i + 1]
                    and data[i] == data[i + 2]):
                break
            i += 1
        count = i - start
        out.append(256 - count)
        out += data[start:i]
    return bytes(out)


def _decompress_chunk(raw, size, expected, compression, channels,
                      width, n_lines):
    """One chunk's payload -> uncompressed scanline-block bytes."""
    if size < expected:
        if compression in (COMPRESSION_ZIP, COMPRESSION_ZIPS):
            raw = _zip_decode(raw, expected)
        elif compression == COMPRESSION_RLE:
            raw = _rle_decode(raw, expected)
        elif compression == COMPRESSION_PIZ:
            raw = _piz.piz_uncompress(
                raw, channels, width, n_lines, _TYPE_SIZE
            )
        elif compression == COMPRESSION_PXR24:
            raw = _pxr24_b44.pxr24_uncompress(
                raw, channels, width, n_lines, _TYPE_SIZE
            )
        elif compression in (COMPRESSION_B44, COMPRESSION_B44A):
            raw = _pxr24_b44.b44_uncompress(
                raw, channels, width, n_lines, _TYPE_SIZE
            )
    # size == expected means the writer stored the block raw (the
    # OpenEXR convention: compressors whose output would be >= the
    # input emit the input unchanged).
    if len(raw) != expected:
        raise ExrError("bad chunk size")
    return raw


def _fill_planes(planes, raw, channels, width, n_lines, row0, col0=0):
    """Scatter a decompressed scanline block into the channel planes
    (rows row0..row0+n_lines-1, columns col0..col0+width-1)."""
    buf = np.frombuffer(raw, np.uint8)
    bytes_per_line = sum(_TYPE_SIZE[c["type"]] * width for c in channels)
    line_start = 0
    for li in range(n_lines):
        row = row0 + li
        chan_pos = line_start
        for c in channels:
            nbytes = _TYPE_SIZE[c["type"]] * width
            vals = np.frombuffer(
                buf[chan_pos:chan_pos + nbytes].tobytes(),
                _TYPE_DTYPE[c["type"]],
            )
            planes[c["name"]][row, col0:col0 + width] = (
                vals.astype(np.float32)
            )
            chan_pos += nbytes
        line_start += bytes_per_line


def _planes_to_rgba(planes, height, width):
    img = np.zeros((height, width, 4), np.float32)
    img[..., 3] = 1.0
    for i, name in enumerate("RGBA"):
        if name in planes:
            img[..., i] = planes[name]
    return img


def _num_tiles(header):
    """Offset-table entry count for a tiled part (level 0 first;
    ONE_LEVEL / MIPMAP / RIPMAP per the tiledesc)."""
    xmin, ymin, xmax, ymax = header["dataWindow"]
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    td = header["tiles"]
    xs, ys = td["x_size"], td["y_size"]
    mode, rnd = td["level_mode"], td["rounding_mode"]

    def _level_size(n, level):
        d = 1 << level
        if rnd == 1:  # round up
            return max(1, (n + d - 1) // d)
        return max(1, n // d)

    def _tiles_for(wl, hl):
        return ((wl + xs - 1) // xs) * ((hl + ys - 1) // ys)

    def _num_levels(n):
        lev = 0
        while n > 1:
            n = _level_size0(n)
            lev += 1
        return lev + 1

    def _level_size0(n):
        return (n + 1) // 2 if rnd == 1 else n // 2

    if mode == 0:  # ONE_LEVEL
        return _tiles_for(w, h)
    if mode == 1:  # MIPMAP_LEVELS
        levels = max(_num_levels(w), _num_levels(h))
        return sum(
            _tiles_for(_level_size(w, l), _level_size(h, l))
            for l in range(levels)
        )
    if mode == 2:  # RIPMAP_LEVELS
        lx = _num_levels(w)
        ly = _num_levels(h)
        return sum(
            _tiles_for(_level_size(w, i), _level_size(h, j))
            for j in range(ly) for i in range(lx)
        )
    raise ExrError("bad tile level mode: %d" % mode)


def _read_tiled_part(data, header, offsets):
    """Assemble level (0, 0) of a tiled part."""
    xmin, ymin, xmax, ymax = header["dataWindow"]
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    compression = header.get("compression", COMPRESSION_NONE)
    channels = sorted(header["channels"], key=lambda c: c["name"])
    td = header["tiles"]
    xs, ys = td["x_size"], td["y_size"]

    planes = {
        c["name"]: np.zeros((height, width), np.float32)
        for c in channels
    }
    for off in offsets:
        dx, dy, lx, ly, size = struct.unpack_from("<5i", data, off)
        raw = data[off + 20: off + 20 + size]
        if lx != 0 or ly != 0:
            continue  # only the full-resolution level
        tw = min(xs, width - dx * xs)
        th = min(ys, height - dy * ys)
        expected = sum(_TYPE_SIZE[c["type"]] * tw for c in channels) * th
        raw = _decompress_chunk(raw, size, expected, compression,
                                channels, tw, th)
        _fill_planes(planes, raw, channels, tw, th,
                     row0=dy * ys, col0=dx * xs)
    return _planes_to_rgba(planes, height, width), header


def _read_scanline_part(data, header, offsets, multipart=False):
    xmin, ymin, xmax, ymax = header["dataWindow"]
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    compression = header.get("compression", COMPRESSION_NONE)
    if compression not in _LINES_PER_CHUNK:
        raise ExrError("unsupported compression: %d" % compression)
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    channels = sorted(header["channels"], key=lambda c: c["name"])
    bytes_per_line = sum(
        _TYPE_SIZE[c["type"]] * width for c in channels
    )
    planes = {
        c["name"]: np.zeros((height, width), np.float32)
        for c in channels
    }
    for off in offsets:
        if multipart:
            _part, y, size = struct.unpack_from("<iii", data, off)
            payload = off + 12
        else:
            y, size = struct.unpack_from("<ii", data, off)
            payload = off + 8
        raw = data[payload: payload + size]
        n_lines = min(lines_per_chunk, ymax - y + 1)
        expected = bytes_per_line * n_lines
        raw = _decompress_chunk(raw, size, expected, compression,
                                channels, width, n_lines)
        _fill_planes(planes, raw, channels, width, n_lines,
                     row0=y - ymin)
    return _planes_to_rgba(planes, height, width), header


def read_pixels(file_path, part=None):
    """Read an EXR; returns (image (H, W, 4) float32 RGBA, header).

    Handles single-part scanline, single-part tiled (level 0), and
    multi-part scanline files; `part` selects a multi-part part by
    index or name (default: first part).  Missing channels fill with 0
    (alpha 1).  Mirrors image_read_pixels_exr_f32x4
    (ref: lib/rust/mmimage/src/lib.rs:64).
    """
    with open(file_path, "rb") as f:
        data = f.read()
    version = struct.unpack_from("<i", data, 4)[0]
    if version & 0x1000:
        headers, pos = _parse_multipart(data)
        # Offset tables are sequential per part, chunkCount each.
        tables = []
        for h in headers:
            n = h.get("chunkCount")
            if n is None:
                raise ExrError("multi-part part missing chunkCount")
            tables.append(struct.unpack_from("<%dQ" % n, data, pos))
            pos += 8 * n
        if part is None:
            index = 0
        elif isinstance(part, str):
            names = [h.get("name") for h in headers]
            if part not in names:
                raise ExrError("no part named %r (have %s)"
                               % (part, names))
            index = names.index(part)
        else:
            index = int(part)
        header = headers[index]
        ptype = header.get("type", "scanlineimage")
        if ptype != "scanlineimage":
            raise ExrError("unsupported part type: %r" % ptype)
        return _read_scanline_part(data, header, tables[index],
                                   multipart=True)

    header, pos = _parse_header(data)
    if header.get("tiled"):
        n = _num_tiles(header)
        offsets = struct.unpack_from("<%dQ" % n, data, pos)
        return _read_tiled_part(data, header, offsets)

    xmin, ymin, xmax, ymax = header["dataWindow"]
    height = ymax - ymin + 1
    compression = header.get("compression", COMPRESSION_NONE)
    if compression not in _LINES_PER_CHUNK:
        raise ExrError("unsupported compression: %d" % compression)
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    num_chunks = (height + lines_per_chunk - 1) // lines_per_chunk
    offsets = struct.unpack_from("<%dQ" % num_chunks, data, pos)
    return _read_scanline_part(data, header, offsets)


_CHAN_INDEX = {"R": 0, "G": 1, "B": 2, "A": 3}


def _check_image(image):
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("image must be (H, W, 3|4)")
    return image


def _rgba_channels(nchan, ptype):
    names = ["R", "G", "B", "A"][:nchan]
    return names, [
        {"name": n, "type": ptype, "x_sampling": 1, "y_sampling": 1}
        for n in sorted(names)
    ]


def _pack_attr(name, atype, payload):
    return (
        name.encode("latin-1") + b"\0" + atype.encode("latin-1")
        + b"\0" + struct.pack("<i", len(payload)) + payload
    )


def _common_attrs(width, height, channels, compression,
                  extra_attributes=None):
    dw = struct.pack("<4i", 0, 0, width - 1, height - 1)
    attrs = [
        _pack_attr("channels", "chlist", _pack_channels(channels)),
        _pack_attr("compression", "compression", bytes([compression])),
        _pack_attr("dataWindow", "box2i", dw),
        _pack_attr("displayWindow", "box2i", dw),
        _pack_attr("lineOrder", "lineOrder", b"\0"),
        _pack_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _pack_attr("screenWindowCenter", "v2f",
                   struct.pack("<2f", 0.0, 0.0)),
        _pack_attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]
    for name, (atype, payload) in (extra_attributes or {}).items():
        attrs.append(_pack_attr(name, atype, payload))
    return attrs


def _block_bytes(image, y0, n_lines, x0, width, names, dtype):
    """Scanline-block bytes for a window of the image."""
    rows = []
    for li in range(n_lines):
        for cname in sorted(names):
            rows.append(
                image[y0 + li, x0:x0 + width, _CHAN_INDEX[cname]]
                .astype(dtype)
                .tobytes()
            )
    return b"".join(rows)


def _compress_block(raw, compression, channels, width, n_lines):
    if compression in (COMPRESSION_ZIP, COMPRESSION_ZIPS):
        packed = _zip_encode(raw)
    elif compression == COMPRESSION_RLE:
        packed = _rle_encode(raw)
    elif compression == COMPRESSION_PIZ:
        packed = _piz.piz_compress(
            raw, channels, width, n_lines, _TYPE_SIZE
        )
    elif compression == COMPRESSION_PXR24:
        packed = _pxr24_b44.pxr24_compress(
            raw, channels, width, n_lines, _TYPE_SIZE
        )
    elif compression == COMPRESSION_B44:
        packed = _pxr24_b44.b44_compress(
            raw, channels, width, n_lines, _TYPE_SIZE, opt_flat=False
        )
    elif compression == COMPRESSION_B44A:
        packed = _pxr24_b44.b44_compress(
            raw, channels, width, n_lines, _TYPE_SIZE, opt_flat=True
        )
    else:
        packed = raw
    return raw if len(packed) >= len(raw) else packed


def write_pixels(file_path, image, compression=COMPRESSION_ZIP,
                 half_precision=False, extra_attributes=None):
    """Write (H, W, 3|4) float array as scanline EXR RGBA/RGB.

    Mirrors image_write_pixels_exr_f32x4
    (ref: lib/rust/mmimage/src/lib.rs:142); extra_attributes is a dict
    name -> (type_name, raw bytes) for metadata round-trip.
    """
    image = _check_image(image)
    height, width, nchan = image.shape
    ptype = _HALF if half_precision else _FLOAT
    dtype = _TYPE_DTYPE[ptype]
    names, channels = _rgba_channels(nchan, ptype)
    lines_per_chunk = _LINES_PER_CHUNK[compression]

    attrs = _common_attrs(width, height, channels, compression,
                          extra_attributes)
    header = _MAGIC + struct.pack("<i", 2) + b"".join(attrs) + b"\0"

    chunks = []
    y = 0
    while y < height:
        n_lines = min(lines_per_chunk, height - y)
        raw = _block_bytes(image, y, n_lines, 0, width, names, dtype)
        chunks.append(
            (y, _compress_block(raw, compression, channels, width,
                                n_lines))
        )
        y += n_lines

    first_chunk = len(header) + 8 * len(chunks)
    offsets = []
    pos = first_chunk
    for y, packed in chunks:
        offsets.append(pos)
        pos += 8 + len(packed)

    with open(file_path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<%dQ" % len(offsets), *offsets))
        for (y, packed) in chunks:
            f.write(struct.pack("<ii", y, len(packed)))
            f.write(packed)


def write_pixels_tiled(file_path, image, tile_size=(64, 64),
                       compression=COMPRESSION_ZIP,
                       half_precision=False, extra_attributes=None):
    """Write a single-part ONE_LEVEL tiled EXR (tiles compressed
    independently; version flag 0x200, tiledesc attribute)."""
    image = _check_image(image)
    height, width, nchan = image.shape
    xs, ys = int(tile_size[0]), int(tile_size[1])
    ptype = _HALF if half_precision else _FLOAT
    dtype = _TYPE_DTYPE[ptype]
    names, channels = _rgba_channels(nchan, ptype)

    attrs = _common_attrs(width, height, channels, compression,
                          extra_attributes)
    attrs.append(_pack_attr("tiles", "tiledesc",
                            struct.pack("<IIB", xs, ys, 0)))
    header = (_MAGIC + struct.pack("<i", 2 | 0x200)
              + b"".join(attrs) + b"\0")

    chunks = []
    ny = (height + ys - 1) // ys
    nx = (width + xs - 1) // xs
    for dy in range(ny):
        for dx in range(nx):
            tw = min(xs, width - dx * xs)
            th = min(ys, height - dy * ys)
            raw = _block_bytes(image, dy * ys, th, dx * xs, tw,
                               names, dtype)
            chunks.append(
                (dx, dy,
                 _compress_block(raw, compression, channels, tw, th))
            )

    first_chunk = len(header) + 8 * len(chunks)
    offsets = []
    pos = first_chunk
    for dx, dy, packed in chunks:
        offsets.append(pos)
        pos += 20 + len(packed)

    with open(file_path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<%dQ" % len(offsets), *offsets))
        for dx, dy, packed in chunks:
            f.write(struct.pack("<5i", dx, dy, 0, 0, len(packed)))
            f.write(packed)


def write_pixels_multipart(file_path, parts, compression=COMPRESSION_ZIP,
                           half_precision=False):
    """Write a multi-part scanline EXR.  `parts` is a list of
    (name, image) pairs; each part gets its own header (name/type/
    chunkCount) and offset table (version flag 0x1000; chunk records
    carry the part number)."""
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    ptype = _HALF if half_precision else _FLOAT
    dtype = _TYPE_DTYPE[ptype]

    part_headers = []
    part_chunks = []
    for name, image in parts:
        image = _check_image(image)
        height, width, nchan = image.shape
        names, channels = _rgba_channels(nchan, ptype)
        chunks = []
        y = 0
        while y < height:
            n_lines = min(lines_per_chunk, height - y)
            raw = _block_bytes(image, y, n_lines, 0, width, names,
                               dtype)
            chunks.append(
                (y, _compress_block(raw, compression, channels,
                                    width, n_lines))
            )
            y += n_lines
        attrs = _common_attrs(width, height, channels, compression)
        attrs.append(_pack_attr("name", "string",
                                name.encode("latin-1")))
        attrs.append(_pack_attr("type", "string", b"scanlineimage"))
        attrs.append(_pack_attr("chunkCount", "int",
                                struct.pack("<i", len(chunks))))
        part_headers.append(b"".join(attrs) + b"\0")
        part_chunks.append(chunks)

    header = (_MAGIC + struct.pack("<i", 2 | 0x1000)
              + b"".join(part_headers) + b"\0")

    total_chunks = sum(len(c) for c in part_chunks)
    pos = len(header) + 8 * total_chunks
    tables = []
    records = []
    for pi, chunks in enumerate(part_chunks):
        offs = []
        for y, packed in chunks:
            offs.append(pos)
            records.append(
                struct.pack("<iii", pi, y, len(packed)) + packed
            )
            pos += 12 + len(packed)
        tables.append(offs)

    with open(file_path, "wb") as f:
        f.write(header)
        for offs in tables:
            f.write(struct.pack("<%dQ" % len(offs), *offs))
        for rec in records:
            f.write(rec)
