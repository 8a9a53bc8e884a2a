"""Conversions the tools share: the reference passes numpy arrays and
jax arrays alike to its jitted functions; the port turns frame indices
into a tensor on the scene's device, once, and reads results back in
one transfer."""

import numpy as np
import torch


def frame_tensor(frame_indices, scene):
    """Frame indices as an int64 tensor on the scene's device."""
    device = scene.tfm_parent.device
    if torch.is_tensor(frame_indices):
        return frame_indices.to(device).long()
    return torch.as_tensor(np.asarray(frame_indices, np.int64),
                           device=device)


def host(*tensors):
    """The tensors as numpy arrays, read from the device together."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out
