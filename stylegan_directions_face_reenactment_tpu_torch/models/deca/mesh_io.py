"""DECA mesh export and the visualization grid, on the host (numpy).

The reference's OBJ/PLY writers and ``DECA.visualize`` grid, taking torch
tensors (on any device) or numpy arrays alike:

* ``write_obj``       — `libs/DECA/decalib/utils/util.py:62-155` (PRNet-style
  Wavefront writer with mtl/texture/normal-map sidecars)
* ``upsample_mesh``   — `util.py:26-59` (displacement-map densification via
  the user-downloaded ``texture_data_256.npy`` dense template)
* ``save_obj``        — `decalib/deca.py:254-281` (coarse textured mesh +
  dense detail mesh from a ``decode_deca`` opdict)
* ``save_ply``        — `decalib/deca.py:283-324`
* ``visualize``       — `decalib/deca.py:243-252` (resize each visdict entry,
  torchvision-``make_grid`` each batch, concatenate along width)
* ``load_dense_template`` — `decalib/deca.py:65`

Image channels: the reference round-trips RGB → BGR (its ``tensor2image``)
→ the BGR-reading ``cv2.imwrite``, so its PNGs hold RGB pixels; arrays stay
RGB here and Pillow writes them, the same files. Image inputs are NHWC (or
HWC) RGB in [0, 1], as in the rest of the package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = [
    "write_obj", "upsample_mesh", "save_obj", "save_ply", "visualize",
    "load_dense_template", "to_image_u8",
]


def _host(x, dtype=None) -> np.ndarray:
    """A torch tensor (detached, moved to the host) or an array → numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def to_image_u8(image) -> np.ndarray:
    """[0,1]-float HWC → uint8, the scale/clip of the reference's
    ``tensor2image`` (`util.py:482-487`) without its CHW/BGR shuffles."""
    img = _host(image, np.float32) * 255.0
    return np.clip(img, 0.0, 255.0).astype(np.uint8)


def write_obj(obj_name: str,
              vertices: np.ndarray,
              faces: np.ndarray,
              colors: Optional[np.ndarray] = None,
              texture: Optional[np.ndarray] = None,
              uvcoords: Optional[np.ndarray] = None,
              uvfaces: Optional[np.ndarray] = None,
              inverse_face_order: bool = False,
              normal_map: Optional[np.ndarray] = None) -> None:
    """Wavefront OBJ writer, text-identical to the reference's
    ``util.write_obj`` (`util.py:62-155`): 1-based indices, per-vertex
    colors appended to ``v`` lines, untextured faces written REVERSED
    (``f v3 v2 v1``, the reference's quirk), textured faces as
    ``f v/vt`` triples after the ``vt`` block and a ``usemtl`` line, plus
    a ``.mtl``/``.png`` sidecar pair (and a ``*_normals.png`` displacement
    entry when ``normal_map`` is given).

    texture / normal_map: HWC uint8 RGB (PIL-written; byte-identical to
    the reference's BGR-flip + cv2 BGR-write round trip).
    """
    if obj_name.split(".")[-1] != "obj":
        obj_name = obj_name + ".obj"
    mtl_name = obj_name.replace(".obj", ".mtl")
    texture_name = obj_name.replace(".obj", ".png")
    material_name = "FaceTexture"

    vertices = _host(vertices)
    faces = _host(faces).copy() + 1          # obj indices start at 1
    if inverse_face_order:
        faces = faces[:, [2, 1, 0]]
        if uvfaces is not None:
            uvfaces = _host(uvfaces)[:, [2, 1, 0]]

    with open(obj_name, "w") as f:
        if texture is not None:
            f.write("mtllib %s\n\n" % os.path.basename(mtl_name))

        if colors is None:
            for i in range(vertices.shape[0]):
                f.write("v {} {} {}\n".format(
                    vertices[i, 0], vertices[i, 1], vertices[i, 2]))
        else:
            colors = _host(colors)
            for i in range(vertices.shape[0]):
                f.write("v {} {} {} {} {} {}\n".format(
                    vertices[i, 0], vertices[i, 1], vertices[i, 2],
                    colors[i, 0], colors[i, 1], colors[i, 2]))

        if texture is None:
            # the reference writes untextured faces back-to-front
            for i in range(faces.shape[0]):
                f.write("f {} {} {}\n".format(
                    faces[i, 2], faces[i, 1], faces[i, 0]))
        else:
            uvcoords = _host(uvcoords)
            for i in range(uvcoords.shape[0]):
                f.write("vt {} {}\n".format(uvcoords[i, 0], uvcoords[i, 1]))
            f.write("usemtl %s\n" % material_name)
            uvfaces = _host(uvfaces) + 1
            for i in range(faces.shape[0]):
                f.write("f {}/{} {}/{} {}/{}\n".format(
                    faces[i, 0], uvfaces[i, 0],
                    faces[i, 1], uvfaces[i, 1],
                    faces[i, 2], uvfaces[i, 2]))
            with open(mtl_name, "w") as m:
                m.write("newmtl %s\n" % material_name)
                m.write("map_Kd {}\n".format(os.path.basename(texture_name)))
                if normal_map is not None:
                    name, _ = os.path.splitext(obj_name)
                    normal_name = f"{name}_normals.png"
                    m.write(f"disp {normal_name}")
                    _write_png(normal_name, normal_map)
            _write_png(texture_name, texture)


def _write_png(path: str, image_u8: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(_host(image_u8, np.uint8)).save(path)


def load_dense_template(path: str) -> Dict[str, np.ndarray]:
    """The pickled dense-mesh template (``texture_data_256.npy``), a user
    download like the checkpoints (`decalib/deca.py:65`,
    `utils/config.py:24`): {img_size, f, x_coords, y_coords,
    valid_pixel_ids, valid_pixel_3d_faces, valid_pixel_b_coords}."""
    return np.load(path, allow_pickle=True, encoding="latin1").item()


def upsample_mesh(vertices: np.ndarray, normals: np.ndarray,
                  faces: np.ndarray, displacement_map: np.ndarray,
                  texture_map: np.ndarray,
                  dense_template: Dict[str, np.ndarray]):
    """Densify the coarse FLAME mesh with the displacement map
    (`util.py:26-59`): barycentric-interpolate positions and normals at
    the template's valid UV pixels, offset along the (re)normalized
    normal by the sampled displacement, color from the texture map.

    Returns (dense_vertices (N,3), dense_colors (N,3), dense_faces)."""
    dense_faces = dense_template["f"]
    x_coords = dense_template["x_coords"]
    y_coords = dense_template["y_coords"]
    valid_pixel_ids = dense_template["valid_pixel_ids"]
    tri = dense_template["valid_pixel_3d_faces"]
    bary = dense_template["valid_pixel_b_coords"]

    vertices = _host(vertices)
    normals = _host(normals)
    pixel_points = (vertices[tri[:, 0]] * bary[:, 0:1]
                    + vertices[tri[:, 1]] * bary[:, 1:2]
                    + vertices[tri[:, 2]] * bary[:, 2:3])
    pixel_normals = (normals[tri[:, 0]] * bary[:, 0:1]
                     + normals[tri[:, 1]] * bary[:, 1:2]
                     + normals[tri[:, 2]] * bary[:, 2:3])
    pixel_normals = pixel_normals / np.linalg.norm(
        pixel_normals, axis=-1, keepdims=True)
    ys = y_coords[valid_pixel_ids].astype(int)
    xs = x_coords[valid_pixel_ids].astype(int)
    displacements = _host(displacement_map)[ys, xs]
    dense_colors = _host(texture_map)[ys, xs]
    dense_vertices = pixel_points + displacements[:, None] * pixel_normals
    return dense_vertices, dense_colors, dense_faces


def save_obj(filename: str, opdict: Dict[str, np.ndarray],
             faces: np.ndarray,
             uvcoords: np.ndarray, uvfaces: np.ndarray,
             dense_template: Optional[Dict[str, np.ndarray]] = None,
             index: int = 0) -> None:
    """``DECA.save_obj`` (`decalib/deca.py:254-281`) over a ``decode_deca``
    opdict: writes the coarse mesh with the extracted UV texture
    (``uv_texture_gt``) and detail-normal map, then — when the
    ``dense_template`` download is supplied — the displacement-upsampled
    dense mesh as ``*_detail.obj`` (vertex colors 0-255, face order
    inverted like the reference).

    faces: FLAME triangles (``params['flame']['faces']``); uvcoords /
    uvfaces: raw UV atlas from ``load_render_assets``. opdict images are
    NHWC RGB in [0, 1]."""
    i = index
    vertices = _host(opdict["vertices"][i])
    faces = _host(faces)
    if faces.ndim == 3:                     # batched topology, as in render
        faces = faces[0]
    texture = to_image_u8(opdict["uv_texture_gt"][i])
    normal_map = to_image_u8(
        _host(opdict["uv_detail_normals"][i]) * 0.5 + 0.5)
    write_obj(filename, vertices, faces,
              texture=texture, uvcoords=_host(uvcoords),
              uvfaces=_host(uvfaces), normal_map=normal_map)
    if dense_template is None:
        return
    normals = _host(opdict["normals"][i])
    displacement_map = _host(opdict["displacement_map"][i]).squeeze()
    dense_vertices, dense_colors, dense_faces = upsample_mesh(
        vertices, normals, faces, displacement_map, texture, dense_template)
    if filename.split(".")[-1] != "obj":
        filename = filename + ".obj"
    write_obj(filename.replace(".obj", "_detail.obj"),
              dense_vertices, dense_faces, colors=dense_colors,
              inverse_face_order=True)


def save_ply(filename: str, opdict: Dict[str, np.ndarray],
             faces: np.ndarray, index: int = 0) -> None:
    """``DECA.save_ply`` (`decalib/deca.py:283-324`): ascii PLY of the
    coarse mesh, vertices at 2 decimals. Deviation: the reference's
    triple-quoted header string carries its source indentation into the
    file (unparseable by strict readers); we emit the dedented, valid
    header with the same fields."""
    vertices = _host(opdict["vertices"][index])
    faces = _host(faces)
    if faces.ndim == 3:
        faces = faces[0]
    header = ("ply\nformat ascii 1.0\nelement vertex {}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "element face {}\nproperty list uchar int vertex_indices\n"
              "end_header").format(vertices.shape[0], faces.shape[0])
    with open(filename, "w") as f:
        f.write(header + "\n")
        for i in range(vertices.shape[0]):
            x, y, z = vertices[i, :]
            f.write(f"{x:.2f} {y:.2f} {z:.2f}\n")
        for i in range(faces.shape[0]):
            idx1, idx2, idx3 = faces[i]
            f.write(f"3 {idx1} {idx2} {idx3}\n")


def _make_grid(batch_hwc: np.ndarray, nrow: int = 8,
               padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """torchvision ``make_grid`` layout in numpy/NHWC: images tile
    left-to-right in rows of ``nrow`` with ``padding`` px of ``pad_value``
    on the top/left of every cell (so the grid has a top-left border but
    none on the bottom/right edges)."""
    b, h, w, c = batch_hwc.shape
    xmaps = min(nrow, b)
    ymaps = (b + xmaps - 1) // xmaps
    hp, wp = h + padding, w + padding
    grid = np.full((hp * ymaps + padding, wp * xmaps + padding, c),
                   pad_value, batch_hwc.dtype)
    for k in range(b):
        y, x = divmod(k, xmaps)
        grid[y * hp + padding:y * hp + padding + h,
             x * wp + padding:x * wp + padding + w] = batch_hwc[k]
    return grid


def _resize_nearest(batch_hwc: np.ndarray, size: int) -> np.ndarray:
    """torch ``F.interpolate(mode='nearest')`` indexing: src = ⌊dst·in/out⌋."""
    h, w = batch_hwc.shape[1:3]
    ys = np.floor(np.arange(size) * (h / size)).astype(np.int64)
    xs = np.floor(np.arange(size) * (w / size)).astype(np.int64)
    return batch_hwc[:, ys][:, :, xs]


def visualize(visdict: Dict[str, np.ndarray], size: int = 224) -> np.ndarray:
    """``DECA.visualize`` (`decalib/deca.py:243-252`): nearest-resize every
    visdict entry to ``size`` (``F.interpolate`` default mode), grid each
    batch (8 per row, 2 px padding), concatenate the grids along width,
    return HWC uint8. Inputs NHWC RGB in [0, 1]; output RGB (the reference
    returns BGR for cv2.imwrite — same pixels, cv2 channel order)."""
    grids = []
    for key in visdict:
        batch = _host(visdict[key], np.float32)
        grids.append(_make_grid(_resize_nearest(batch, size)))
    grid = np.concatenate(grids, axis=1)
    return np.clip(grid * 255.0, 0.0, 255.0).astype(np.uint8)
