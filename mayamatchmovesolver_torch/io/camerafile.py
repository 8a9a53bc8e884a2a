""".mmcamera camera file read/write.

Counterpart of the reference's copy/paste-camera tools and the
3DEqualizer `mmcamera_format` exporter
(ref: python/mmSolver/tools/copypastecamera/lib.py:406-530 —
query_camera_data/generate — and constant.py:23-29: JSON with
{'version': 1, 'data': {name, start_frame, end_frame, image{...},
attr{attrName: [(frame, value), ...]}}}).  Values are in millimetres
for film back / focal length, matching the reference.

Port of mayamatchmovesolver_tpu/io/camerafile.py: a copy of the
reference's host code.  write_camera reads the port's AttrBlock
tensors to the host once and writes the same JSON bytes;
create_camera_from_file builds the camera in the port's SceneGraph.
"""

import json

import numpy as np

MM_CAMERA_FORMAT_VERSION_1 = 1
EXT = ".mmcamera"

# Maya attribute name -> our camera kwargs / attr channels.
_TFM_ATTRS = {
    "translateX": "tx",
    "translateY": "ty",
    "translateZ": "tz",
    "rotateX": "rx",
    "rotateY": "ry",
    "rotateZ": "rz",
}
_CAM_ATTRS = {
    "focalLength": "focal_length_mm",
    "filmBackWidth": "sensor_width_mm",
    "filmBackHeight": "sensor_height_mm",
    "filmBackOffsetX": "lens_offset_x_mm",
    "filmBackOffsetY": "lens_offset_y_mm",
}


def generate(
    name,
    frame_range,
    attr_data,
    image_path=None,
    image_width=None,
    image_height=None,
    pixel_aspect=None,
):
    """Build the v1 payload dict
    (ref: copypastecamera/lib.py:482 generate)."""
    return {
        "version": MM_CAMERA_FORMAT_VERSION_1,
        "data": {
            "name": str(name),
            "start_frame": int(frame_range[0]),
            "end_frame": int(frame_range[1]),
            "image": {
                "file_path": image_path,
                "width": image_width,
                "height": image_height,
                "pixel_aspect_ratio": pixel_aspect,
            },
            "attr": attr_data,
        },
    }


def _channel_pairs(frames, values):
    values = np.asarray(values, dtype=float)
    if values.ndim == 0:
        values = np.full(len(frames), float(values))
    return [[int(f), float(v)] for f, v in zip(frames, values)]


def write_camera(
    path, camera, attrs, frame_range, image=None
):
    """Write a SceneGraph camera to a .mmcamera file.

    camera: scenegraph Camera handle; attrs: baked AttrBlock;
    frame_range: (start, end) inclusive; image: optional dict with
    file_path/width/height/pixel_aspect_ratio.
    """
    start, end = int(frame_range[0]), int(frame_range[1])
    frames = list(range(start, end + 1))
    anim = attrs.anim_values.detach().cpu().numpy()
    static = attrs.static_values.detach().cpu().numpy()

    def channel_values(attr):
        code = attr.code
        if code < 0:
            return np.zeros(len(frames))
        if code % 2 == 1:
            return anim[code // 2][: len(frames)]
        return np.full(len(frames), static[code // 2])

    attr_data = {}
    for maya_name, ch in _TFM_ATTRS.items():
        attr_data[maya_name] = _channel_pairs(
            frames, channel_values(camera.attr(ch))
        )
    for maya_name, ch in _CAM_ATTRS.items():
        try:
            a = camera.attr(ch)
        except KeyError:
            continue
        attr_data[maya_name] = _channel_pairs(
            frames, channel_values(a)
        )

    image = image or {}
    payload = generate(
        camera.name,
        (start, end),
        attr_data,
        image_path=image.get("file_path"),
        image_width=image.get("width"),
        image_height=image.get("height"),
        pixel_aspect=image.get("pixel_aspect_ratio"),
    )
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


class CameraData:
    """Parsed .mmcamera content: dense channels over the frame range."""

    def __init__(self, name, start_frame, end_frame, channels, image):
        self.name = name
        self.start_frame = start_frame
        self.end_frame = end_frame
        self.channels = channels  # our-name -> (F,) np array
        self.image = image

    @property
    def frame_range(self):
        return (self.start_frame, self.end_frame)


def read_camera(path):
    """Read a .mmcamera file into CameraData; channel keys use this
    framework's names (tx..rz, focal_length_mm, sensor_*_mm, ...)."""
    with open(path) as f:
        payload = json.load(f)
    version = payload.get("version")
    if version != MM_CAMERA_FORMAT_VERSION_1:
        raise ValueError("unsupported .mmcamera version %r" % version)
    data = payload["data"]
    start = int(data["start_frame"])
    end = int(data["end_frame"])
    n = end - start + 1
    name_map = dict(_TFM_ATTRS)
    name_map.update(_CAM_ATTRS)
    channels = {}
    for maya_name, pairs in (data.get("attr") or {}).items():
        ours = name_map.get(maya_name)
        if ours is None:
            continue
        dense = np.zeros(n)
        have = np.zeros(n, dtype=bool)
        for f, v in pairs:
            i = int(f) - start
            if 0 <= i < n:
                dense[i] = float(v)
                have[i] = True
        if have.any() and not have.all():
            # Linear-fill missing frames.
            idx = np.arange(n)
            dense = np.interp(idx, idx[have], dense[have])
        channels[ours] = dense
    return CameraData(
        data.get("name", "camera"), start, end, channels,
        data.get("image") or {},
    )


def create_camera_from_file(scene_graph, path, **camera_kwargs):
    """Read a .mmcamera file and create the camera in a SceneGraph
    whose frame range covers the file's (the paste-camera capability,
    ref: python/mmSolver/tools/copypastecamera/tool.py)."""
    data = read_camera(path)
    start, _end = scene_graph.frame_range
    kwargs = dict(camera_kwargs)
    for ch, values in data.channels.items():
        if np.all(values == values[0]):
            kwargs.setdefault(ch, float(values[0]))
        else:
            kwargs.setdefault(ch, values)
    if data.image.get("width"):
        kwargs.setdefault("render_width", int(data.image["width"]))
    if data.image.get("height"):
        kwargs.setdefault("render_height", int(data.image["height"]))
    return scene_graph.create_camera(data.name, **kwargs)
