"""The image warp's share of its roofline: the least time its launches
could take (warp_bytes of the cell's plate over the memory rate,
common/peaks.py) over the device time they took in the profiler, in
percent.  Every instantiation of csrc/warp.cu's warp_kernel counts."""

from mmbench.common import peaks

ITEMSIZE = {"float16": 2, "float32": 4, "float64": 8}


def warp_bytes(width, height, channels, dtype):
    """The bytes one warp of a (height, width, channels) image of `dtype`
    through a map of the same size moves at the least: a destination
    pixel reads its RGBA float32 map texel (16), its share of the image
    read once (channels x itemsize) and writes its float32 output texel
    (channels x 4), the output of either dtype a cell holds."""
    return width * height * (16 + channels * ITEMSIZE[dtype] + channels * 4)


def read(records):
    if records.trace is None:
        return None
    config = records.config
    width, height = config["plate"]
    bound = warp_bytes(width, height, config["channels"],
                       config["dtype"]) / peaks.H100_HBM_BYTES_PER_S
    times = [s for name, s in records.trace.kernels if "warp_kernel<" in name]
    taken = sum(times)
    return 100.0 * bound * len(times) / taken if taken > 0.0 else None
