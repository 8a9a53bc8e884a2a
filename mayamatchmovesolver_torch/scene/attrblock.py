"""Structure-of-arrays attribute storage.

Port of mayamatchmovesolver_tpu/scene/attrblock.py.  Every attribute
reference is one packed integer code:

    code == ATTR_NONE (-1)  -> no attribute (evaluates to 0.0)
    code % 2 == 0           -> static attribute   index = code // 2
    code % 2 == 1           -> animated channel   index = code // 2

Values live in two dense tensors: static (S,) and anim (A, F) where F is
the baked frame count.  Solvers write parameters into copies of them,
out of place, so the residual stays a pure function for torch.func.
"""

import dataclasses

import numpy as np
import torch

ATTR_NONE = -1


def static_code(index):
    return index * 2


def anim_code(index):
    return index * 2 + 1


def is_static_code(code):
    return (code >= 0) & (code % 2 == 0)


def is_anim_code(code):
    return (code >= 0) & (code % 2 == 1)


def code_index(code):
    return code // 2


@dataclasses.dataclass(frozen=True)
class AttrBlock:
    """Attribute value tensors.

    static_values: (S,) float tensor.
    anim_values:   (A, F) float tensor — dense per-frame channels over
                   the baked frame range.
    """

    static_values: torch.Tensor
    anim_values: torch.Tensor

    @property
    def num_static(self):
        return self.static_values.shape[0]

    @property
    def num_anim(self):
        return self.anim_values.shape[0]

    @property
    def num_frames(self):
        return self.anim_values.shape[1]


def gather_attr_values(attrs: AttrBlock, codes, frame_indices):
    """Evaluate attribute codes at frames.

    codes: int tensor (...,) of packed attr codes.
    frame_indices: int tensor (F,) indexing the baked frame axis.
    Either may be a numpy array or a list, as the reference accepts;
    it then joins the attributes' device.
    Returns (..., F) float values; ATTR_NONE yields 0.0.
    """
    device = attrs.static_values.device
    if not torch.is_tensor(codes):
        codes = torch.as_tensor(np.asarray(codes, np.int64), device=device)
    if not torch.is_tensor(frame_indices):
        frame_indices = torch.as_tensor(
            np.asarray(frame_indices, np.int64), device=device)
    idx = torch.clamp(codes, min=0) // 2
    s = attrs.static_values[torch.clamp(idx, 0, attrs.num_static - 1)]
    a = attrs.anim_values[torch.clamp(idx, 0, attrs.num_anim - 1)][
        ..., frame_indices
    ]
    out = torch.where((codes % 2 == 1)[..., None], a, s[..., None])
    return torch.where((codes < 0)[..., None], torch.zeros_like(out), out)


def gather_attr_values_static(attrs: AttrBlock, codes, frame_index=0):
    """Evaluate attribute codes at a single frame; returns (...,) values."""
    frame = torch.tensor([int(frame_index)], device=codes.device)
    return gather_attr_values(attrs, codes, frame)[..., 0]


def set_attr_values(attrs: AttrBlock, code, values, frame_indices=None):
    """Write values into one attribute, returning a new AttrBlock on the
    same device.

    The write-back half of the reference's set_maya_attribute_values
    (adjust_base.cpp:297-342): a static code takes a scalar; an animated
    code takes per-frame values at `frame_indices` (all frames when
    None).  `values` is numbers, a numpy array or a tensor.
    """
    code = int(code)
    if code < 0:
        raise ValueError("cannot write ATTR_NONE")
    idx = code_index(code)
    like = attrs.static_values
    values = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    if is_static_code(code):
        static = attrs.static_values.clone()
        static[idx] = values.reshape(-1)[0]
        return dataclasses.replace(attrs, static_values=static)
    anim = attrs.anim_values.clone()
    if frame_indices is None:
        anim[idx, :] = values
    else:
        frames = torch.as_tensor(np.asarray(frame_indices, dtype=np.int64),
                                 device=like.device)
        anim[idx, frames] = values
    return dataclasses.replace(attrs, anim_values=anim)


class AttrBlockBuilder:
    """Host-side builder accumulating attributes before baking to tensors."""

    def __init__(self, num_frames, dtype=np.float64):
        self._static = []
        self._anim = []
        self.num_frames = int(num_frames)
        self.dtype = dtype

    def add_static(self, value):
        self._static.append(float(value))
        return static_code(len(self._static) - 1)

    def add_anim(self, values):
        values = np.asarray(values, dtype=self.dtype)
        if values.shape != (self.num_frames,):
            raise ValueError(
                "animated attribute needs %d frame values, got shape %r"
                % (self.num_frames, values.shape)
            )
        self._anim.append(values)
        return anim_code(len(self._anim) - 1)

    def add(self, value):
        """Static if scalar, animated if per-frame array."""
        if np.ndim(value) == 0:
            return self.add_static(value)
        return self.add_anim(value)

    def set_value(self, code, value, frame=None):
        """Edit an attribute before bake.  A static code takes a scalar;
        an animated one takes all-frames values, or a scalar at `frame`."""
        idx = code_index(code)
        if is_static_code(code):
            self._static[idx] = float(value)
        elif frame is None:
            self._anim[idx] = np.broadcast_to(
                np.asarray(value, self.dtype), (self.num_frames,)
            ).copy()
        else:
            self._anim[idx][int(frame)] = float(value)

    def get_value(self, code, frame=None):
        """Read an attribute before bake.  Static -> scalar; animated ->
        the per-frame array, or the scalar at `frame`."""
        idx = code_index(code)
        if is_static_code(code):
            return self._static[idx]
        if frame is None:
            return self._anim[idx].copy()
        return float(self._anim[idx][int(frame)])

    def bake(self, dtype=None, *, device):
        """Tensors on `device`, in `dtype` (the builder's by default)."""
        dtype = dtype or self.dtype
        static = np.asarray(self._static, dtype=dtype)
        if static.size == 0:
            static = np.zeros((1,), dtype=dtype)
        if self._anim:
            anim = np.stack(self._anim).astype(dtype)
        else:
            anim = np.zeros((1, self.num_frames), dtype=dtype)
        return AttrBlock(
            static_values=torch.as_tensor(static, device=device),
            anim_values=torch.as_tensor(anim, device=device),
        )
