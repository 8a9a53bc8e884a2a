"""Image read / write / convert utilities.

Capability of the reference's mmReadImage / mmConvertImage commands
(ref: src/mmSolver/cmd/MMReadImageCmd.cpp:49 — width/height/pixel
queries — and MMConvertImageCmd.cpp:188 — resize + format conversion)
plus image-plane pixel access.  EXR goes through our own reader
(io/exr.py); LDR formats go through imageio or PIL, imported only when
an LDR file is read or written.

A copy of mayamatchmovesolver_tpu/io/image.py (host code, no tensors):
the port imports nothing of the JAX package.
"""

import os

import numpy as np

from mayamatchmovesolver_torch.io import exr as exr_mod


def _read_ldr(file_path):
    """LDR decode via imageio, falling back to PIL (either may be
    absent in a minimal install, or installed without a plugin for the
    requested format — OSError; EXR never needs them)."""
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(file_path))
    except (ImportError, OSError):
        from PIL import Image

        return np.asarray(Image.open(file_path))


def _write_ldr(file_path, arr_u8):
    try:
        import imageio.v3 as iio

        iio.imwrite(file_path, arr_u8)
    except (ImportError, OSError):
        from PIL import Image

        Image.fromarray(arr_u8).save(file_path)


def read_image(file_path):
    """Returns ((H, W, 4) float32 RGBA, metadata dict)."""
    ext = os.path.splitext(file_path)[1].lower()
    if ext == ".exr":
        img, header = exr_mod.read_pixels(file_path)
        return img, {"format": "exr", "header": header}
    arr = _read_ldr(file_path)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.ones_like(arr[..., :1])], axis=-1
        )
    return arr, {"format": ext.lstrip(".")}


def image_size(file_path):
    """(width, height) without decoding pixels where possible
    (ref: mmReadImage 'width'/'height' query flags)."""
    ext = os.path.splitext(file_path)[1].lower()
    if ext == ".exr":
        header = exr_mod.read_header(file_path)
        xmin, ymin, xmax, ymax = header["dataWindow"]
        return xmax - xmin + 1, ymax - ymin + 1
    img, _ = read_image(file_path)
    return img.shape[1], img.shape[0]


def resize_image(image, width, height):
    """Bilinear resize (the reference resizes via Maya's MImage;
    ref: MMConvertImageCmd.cpp:188)."""
    image = np.asarray(image, np.float32)
    src_h, src_w = image.shape[:2]
    ys = (np.arange(height) + 0.5) * src_h / height - 0.5
    xs = (np.arange(width) + 0.5) * src_w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, src_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bottom = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return top * (1 - wy) + bottom * wy


def write_image(file_path, image):
    ext = os.path.splitext(file_path)[1].lower()
    image = np.asarray(image, np.float32)
    if ext == ".exr":
        exr_mod.write_pixels(file_path, image)
        return
    out = np.clip(image, 0.0, 1.0)
    _write_ldr(file_path, (out * 255.0 + 0.5).astype(np.uint8))


def convert_image(src_path, dst_path, scale=1.0):
    """Read, optionally resize, re-encode
    (ref: mmConvertImage capability)."""
    img, _ = read_image(src_path)
    if scale != 1.0:
        img = resize_image(
            img,
            max(1, int(round(img.shape[1] * scale))),
            max(1, int(round(img.shape[0] * scale))),
        )
    write_image(dst_path, img)
    return img.shape[1], img.shape[0]
