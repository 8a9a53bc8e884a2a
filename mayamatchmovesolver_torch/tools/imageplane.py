"""Image-plane data rig.

The reference's createimageplane tool builds an mmImagePlane node rig
under a camera: a textured card whose size exactly fills the camera
frustum at a chosen depth, following focal length / film back / film
offsets live, with an image-sequence attribute resolved per frame and
image size queried through mmReadImage
(ref: python/mmSolver/tools/createimageplane/lib.py,
_lib/mmimageplane.py:452 set_image_sequence,
src/mmSolver/shape/ImagePlaneShapeNode.h:47-101,
src/mmSolver/shape/ImagePlaneGeometryOverride.cpp).

The viewport drawing is out of scope (SURVEY.md §7); what survives is
the data rig: frustum-fitted plane geometry per frame, the scene-graph
transform that places it, and the image-sequence/size plumbing.

Port of mayamatchmovesolver_tpu/tools/imageplane.py: a copy of the
reference's host code, on the port's SceneGraph, io.image and
utils.imageseq.
"""

import numpy as np

from mayamatchmovesolver_torch.core.constants import FilmFit

MM_PER_INCH = 25.4


def image_plane_size(
    focal_length_mm,
    film_back_width_mm,
    film_back_height_mm,
    depth,
    film_offset_x_mm=0.0,
    film_offset_y_mm=0.0,
):
    """Width/height/center of a plane filling the film gate at `depth`
    in front of the camera (similar triangles: size = film_back *
    depth / focal; ref: createimageplane/_lib/mmimageplane.py scales
    the poly plane by the camera's aperture-to-focal ratio).

    Returns dict with width, height, center_x, center_y (scene units).
    """
    depth = float(depth)
    scale = depth / float(focal_length_mm)
    return {
        "width": float(film_back_width_mm) * scale,
        "height": float(film_back_height_mm) * scale,
        "center_x": float(film_offset_x_mm) * scale,
        "center_y": float(film_offset_y_mm) * scale,
    }


def image_plane_corners(
    focal_length_mm,
    film_back_width_mm,
    film_back_height_mm,
    depth,
    film_offset_x_mm=0.0,
    film_offset_y_mm=0.0,
):
    """(4, 3) camera-space corners of the image plane at `depth`
    (counter-clockwise from bottom-left; camera looks down -Z), plus
    (4, 2) UVs."""
    s = image_plane_size(
        focal_length_mm, film_back_width_mm, film_back_height_mm,
        depth, film_offset_x_mm, film_offset_y_mm,
    )
    hw, hh = s["width"] / 2.0, s["height"] / 2.0
    cx, cy = s["center_x"], s["center_y"]
    corners = np.array(
        [
            [cx - hw, cy - hh, -depth],
            [cx + hw, cy - hh, -depth],
            [cx + hw, cy + hh, -depth],
            [cx - hw, cy + hh, -depth],
        ],
        np.float64,
    )
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    return corners, uvs


def create_image_plane(sg, camera, depth=10.0, image_path=None,
                       name=None):
    """Create the image-plane transform under `camera` in the scene
    graph: positioned at -depth on the camera's Z axis, scaled to fill
    the frustum (ref: createimageplane/lib.py create_image_plane_on_camera).

    Returns (transform node, info dict).  If `image_path` is given the
    image size is read (io/image.py — the mmReadImage capability) and
    stored in the info dict together with the frustum fit.
    """
    focal = np.mean(sg.get_value(camera.attr("focal_length_mm")))
    fbw = np.mean(sg.get_value(camera.attr("sensor_width_mm")))
    fbh = np.mean(sg.get_value(camera.attr("sensor_height_mm")))
    size = image_plane_size(focal, fbw, fbh, depth)
    name = name or (camera.name + "_imagePlane")
    node = sg.create_transform(
        name, parent=camera,
        tx=size["center_x"], ty=size["center_y"], tz=-depth,
    )
    info = dict(size)
    info["depth"] = float(depth)
    if image_path is not None:
        from mayamatchmovesolver_torch.io import image as image_mod

        width, height = image_mod.image_size(image_path)
        info["image_width"] = width
        info["image_height"] = height
        info["image_aspect"] = width / float(height)
        info["image_path"] = image_path
    return node, info


def image_sequence_paths(pattern, frames):
    """Resolve an image-sequence pattern for a list of frames
    (ref: mmimageplane.set_image_sequence resolving '#'-padded
    patterns through utils/imageseq)."""
    from mayamatchmovesolver_torch.utils import imageseq

    return [imageseq.frame_path(pattern, f) for f in frames]


def fit_to_render_resolution(size, render_width, render_height,
                             film_fit=FilmFit.HORIZONTAL):
    """Adjust plane height (or width) so the image aspect matches the
    render resolution under the film-fit mode — what the reference's
    geometry override does when the image aspect differs from the film
    aspect (ImagePlaneGeometryOverride 'card size' logic)."""
    render_aspect = float(render_width) / float(render_height)
    out = dict(size)
    fit = int(film_fit)
    if fit in (int(FilmFit.HORIZONTAL), int(FilmFit.FILL),
               int(FilmFit.OVERSCAN)):
        out["height"] = out["width"] / render_aspect
    else:
        out["width"] = out["height"] * render_aspect
    return out
