"""The DECA renderer: a z-buffer rasterizer, flat and SH shading, UV-space
renders and the reference's visualization decode (``decode_deca``).

PyTorch counterpart of the JAX package's ``models/deca/render.py`` (the
reference's ``decalib/utils/renderer.py`` with its pytorch3d rasterizer at
blur 0, one face a pixel, no perspective correction, and
``decalib/deca.py:114-227``). Images are NHWC at every function boundary.

The rasterizer is brute force, as the JAX package's: for each chunk of
faces, the affine barycentric coordinates of every pixel against every face
of the chunk, with the batch inside. A pixel is covered by a face when its
three coordinates are >= 0; its depth is their interpolation of vertex z;
the face of least z wins, and on a tie the first face index (``min``
returns the first minimum's index within a chunk, and a later chunk replaces the
buffer only when strictly nearer), so the chunk never changes the result.
Uncovered pixels keep z = +inf, zero attributes and zero coverage. The
default chunk (:func:`raster_chunk`) is the JAX package's 256 faces on the
card (at B = 16, 256², it beat 32 and 64); on the host it is the largest
whose (B, chunk, S, S) float32 temporaries stay under
:data:`HOST_RASTER_CHUNK_BYTES` each, so that they stay in cache (at 256²,
B = 1, 8 threads: 4.2 s a rasterization at 16 MiB, 31 s at 256 MiB).

Pixel centres: a vertex at (x, y) of the DECA screen frame ([-1, 1] across
the image, +x right, +y down, +z away) lands on column (x + 1)·S/2 - 0.5
and row (y + 1)·S/2 - 0.5, as the reference's two flips compose.

Where the JAX code stops a gradient, this code detaches at the same place.
Products that could run on TF32 (the lights' einsums, the SH basis) run
with TF32 off. On a CUDA tensor everything runs on the card; nothing falls
back to the host but the landmark drawings of ``decode_deca(...,
draw_landmarks=True)``, which are host numpy in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..nn import full_f32_matmul, grid_sample

Assets = Dict[str, torch.Tensor]

GRAY = 180.0 / 255.0  # the shape overlay's albedo (``renderer.py:112-114``)

# five directional lights of intensity 1.7 (``renderer.py:243-254``)
DEFAULT_LIGHT_POSITIONS = (
    (-1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0),
    (-1.0, -1.0, 1.0),
    (1.0, -1.0, 1.0),
    (0.0, 0.0, 1.0),
)
DEFAULT_LIGHT_INTENSITY = 1.7

RASTER_CHUNK = 256                 # faces a chunk on the card (``render.py`` of JAX)
HOST_RASTER_CHUNK_BYTES = 16 << 20  # the largest (B, chunk, S, S) float32 temporary on the host


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face vertex attributes (``util.py:173-191``): vertices (B, V, D),
    faces (F, 3) → (B, F, 3, D)."""
    return vertices[:, faces]


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (``util.py:193-224``): each face's cross
    product added at its corners 1, 2, 0 (the reference's order), then
    normalized with the norm floored at 1e-6. vertices (B, V, 3), faces
    (F, 3) → (B, V, 3)."""
    fv = vertices[:, faces]                                   # (B, F, 3, 3)
    v0, v1, v2 = fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]
    acc = torch.zeros_like(vertices)
    acc = acc.index_add(1, faces[:, 1], torch.linalg.cross(v2 - v1, v0 - v1))
    acc = acc.index_add(1, faces[:, 2], torch.linalg.cross(v0 - v2, v1 - v2))
    acc = acc.index_add(1, faces[:, 0], torch.linalg.cross(v1 - v0, v2 - v0))
    norm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp_min(norm, 1e-6)


def _shift_z(tv: torch.Tensor) -> torch.Tensor:
    """z + 10, as the reference's renders shift the projected mesh."""
    return torch.cat([tv[..., :2], tv[..., 2:] + 10.0], dim=-1)


def raster_chunk(batch: int, image_size: int, device="cuda") -> int:
    """The default face chunk: :data:`RASTER_CHUNK` on the card; on the
    host the most faces whose (batch, chunk, S, S) float32 temporaries each
    fit in :data:`HOST_RASTER_CHUNK_BYTES`."""
    if torch.device(device).type != "cpu":
        return RASTER_CHUNK
    return max(1, HOST_RASTER_CHUNK_BYTES // (4 * batch * image_size * image_size))


def rasterize(transformed_vertices: torch.Tensor, faces: torch.Tensor,
              attributes: torch.Tensor, image_size: int = 224,
              chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched z-buffer rasterization (``renderer.py:51-79``).

    transformed_vertices (B, V, 3) in the DECA screen frame; faces (F, 3)
    shared by the batch; attributes (B, F, 3, D) per face corner. Returns
    (pixel values (B, S, S, D), coverage (B, S, S)): uncovered pixels are
    zero, coverage is pytorch3d's ``vismask``."""
    batch, size = transformed_vertices.shape[0], image_size
    dev, dt = transformed_vertices.device, transformed_vertices.dtype
    chunk = chunk or raster_chunk(batch, size, dev)
    fxyz = face_vertices(transformed_vertices, faces)        # (B, F, 3, 3)

    coords = (2.0 * (torch.arange(size, dtype=dt, device=dev) + 0.5) / size) - 1.0
    px = coords.reshape(1, 1, 1, size)                       # columns → x
    py = coords.reshape(1, 1, size, 1)                       # rows → y
    # per pixel: the winner's depth, global face index and barycentrics; its
    # attributes are interpolated once, after the last chunk
    zbuf = torch.full((batch, size, size), float("inf"), dtype=dt, device=dev)
    face_buf = torch.zeros((batch, size, size), dtype=torch.int64, device=dev)
    bary_buf = torch.zeros((batch, size, size, 3), dtype=dt, device=dev)
    bidx = torch.arange(batch, device=dev).reshape(batch, 1, 1)

    # without a gradient to keep, the chunk's temporaries are updated in
    # place (the same operations in the same order: half the host's time)
    grad = torch.is_grad_enabled() and (transformed_vertices.requires_grad
                                        or attributes.requires_grad)
    for start in range(0, faces.shape[0], chunk):
        c = fxyz[:, start:start + chunk]                     # (B, C, 3, 3)
        x = c[..., 0][..., None, None]                       # (B, C, 3, 1, 1)
        y = c[..., 1][..., None, None]
        z = c[..., 2][..., None, None]
        area = ((c[:, :, 1, 0] - c[:, :, 0, 0]) * (c[:, :, 2, 1] - c[:, :, 0, 1])
                - (c[:, :, 2, 0] - c[:, :, 0, 0]) * (c[:, :, 1, 1] - c[:, :, 0, 1]))
        ok = area.abs() > 1e-12                              # (B, C)
        inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                          torch.zeros_like(area))[..., None, None]

        def bary(i, j):
            # the signed area of (v_i, v_j, pixel) over the face's, (B, C, S, S)
            e = (x[:, :, i] - px) * (y[:, :, j] - py)
            e = e.sub_((x[:, :, j] - px) * (y[:, :, i] - py))
            return e * inv if grad else e.mul_(inv)

        b0, b1, b2 = bary(1, 2), bary(2, 0), bary(0, 1)
        inside = (b0 >= 0).logical_and_(b1 >= 0).logical_and_(b2 >= 0).logical_and_(
            ok[..., None, None])
        zc = (b0 * z[:, :, 0]).add_(b1 * z[:, :, 1]).add_(b2 * z[:, :, 2])
        zc = zc.masked_fill_(inside.logical_not_(), float("inf"))
        del inside

        # the first minimum's index, as argmin (which is 30× slower over a
        # middle dimension on the host)
        zwin, win = torch.min(zc, dim=1, keepdim=True)       # (B, 1, S, S)
        zwin = zwin[:, 0]
        bwin = torch.stack([torch.gather(b, 1, win)[:, 0] for b in (b0, b1, b2)],
                           dim=-1)                           # (B, S, S, 3)
        del zc, b0, b1, b2
        upd = zwin < zbuf                                    # inf never wins
        zbuf = torch.where(upd, zwin, zbuf)
        face_buf = torch.where(upd, win[:, 0] + start, face_buf)
        bary_buf = torch.where(upd[..., None], bwin, bary_buf)

    cover = (zbuf < float("inf")).to(dt)
    vert_attr = attributes[bidx, face_buf]                   # (B, S, S, 3, D)
    interp = (bary_buf[..., None] * vert_attr).sum(dim=-2)
    return torch.where(cover[..., None] > 0, interp, torch.zeros_like(interp)), cover


def default_lights(batch: int, device=None) -> torch.Tensor:
    """(B, 5, 6) [direction | intensity] (``renderer.py:243-254``)."""
    pos = torch.tensor(DEFAULT_LIGHT_POSITIONS, dtype=torch.float32, device=device)
    lights = torch.cat([pos, torch.full_like(pos, DEFAULT_LIGHT_INTENSITY)], dim=1)
    return lights[None].expand(batch, 5, 6)


def add_directionlight(normals: torch.Tensor, lights: torch.Tensor) -> torch.Tensor:
    """Directional lighting (``renderer.py:225-235``): the mean over lights
    of clamp(n·l, 0, 1)·intensity. normals (B, N, 3); lights (B, L, 6),
    [:, :, :3] the light positions used as directions."""
    direction = lights[:, :, :3]
    intensity = lights[:, :, 3:]
    direction = direction / torch.clamp_min(
        torch.linalg.norm(direction, dim=-1, keepdim=True), 1e-12)
    with full_f32_matmul():
        ndl = torch.clamp(torch.einsum("bld,bnd->bln", direction, normals), 0.0, 1.0)
    shading = ndl[:, :, :, None] * intensity[:, :, None, :]  # (B, L, N, 3)
    return shading.mean(dim=1)


def render_shape(vertices: torch.Tensor, transformed_vertices: torch.Tensor,
                 faces: torch.Tensor, images: Optional[torch.Tensor] = None,
                 lights: Optional[torch.Tensor] = None,
                 detail_normal_images: Optional[torch.Tensor] = None,
                 image_size: int = 224, chunk: Optional[int] = None) -> torch.Tensor:
    """Gray shaded shape, over ``images`` when given (``renderer.py:237-294``).

    vertices (B, V, 3) world mesh; transformed_vertices (B, V, 3) after
    ``batch_orth_proj`` and the y/z flip (unscaled); faces (F, 3); images
    (B, S, S, 3); detail_normal_images (B, S, S, 3) replace the rasterized
    normals before shading. Returns (B, S, S, 3)."""
    batch = vertices.shape[0]
    if lights is None:
        lights = default_lights(batch, vertices.device)
    tv = _shift_z(transformed_vertices)                      # ``renderer.py:255``

    fv_world = face_vertices(vertices, faces)
    face_normals = face_vertices(vertex_normals(vertices, faces), faces)
    t_face_normals = face_vertices(vertex_normals(tv, faces), faces)
    colors = torch.full_like(fv_world, GRAY)
    attributes = torch.cat([colors, t_face_normals, fv_world, face_normals], dim=-1)

    rendering, cover = rasterize(tv, faces, attributes, image_size, chunk)

    albedo = rendering[..., 0:3]
    pos_mask = (rendering[..., 5:6] < 0.15).to(rendering.dtype)
    normal_images = rendering[..., 9:12]
    if detail_normal_images is not None:
        normal_images = detail_normal_images

    shading = add_directionlight(normal_images.reshape(batch, -1, 3), lights)
    shaded = albedo * shading.reshape(batch, image_size, image_size, 3)
    alpha = cover[..., None] * pos_mask
    if images is None:
        return shaded * alpha
    return shaded * alpha + images * (1.0 - alpha)


# SH lighting constants (``renderer.py:114-119``)
_PI = 3.141592653589793
SH_CONSTANT_FACTOR = (
    1.0 / (4.0 * _PI) ** 0.5,
    ((2.0 * _PI) / 3.0) * (3.0 / (4.0 * _PI)) ** 0.5,
    ((2.0 * _PI) / 3.0) * (3.0 / (4.0 * _PI)) ** 0.5,
    ((2.0 * _PI) / 3.0) * (3.0 / (4.0 * _PI)) ** 0.5,
    (_PI / 4.0) * 3.0 * (5.0 / (12.0 * _PI)) ** 0.5,
    (_PI / 4.0) * 3.0 * (5.0 / (12.0 * _PI)) ** 0.5,
    (_PI / 4.0) * 3.0 * (5.0 / (12.0 * _PI)) ** 0.5,
    (_PI / 4.0) * 1.5 * (5.0 / (12.0 * _PI)) ** 0.5,
    (_PI / 4.0) * 0.5 * (5.0 / (4.0 * _PI)) ** 0.5,
)


def add_shlight(normal_images: torch.Tensor, sh_coeff: torch.Tensor) -> torch.Tensor:
    """9-band spherical-harmonic shading (``renderer.py:193-206``):
    normal_images (B, S, S, 3), sh_coeff (B, 9, 3) → (B, S, S, 3)."""
    nx, ny, nz = normal_images[..., 0], normal_images[..., 1], normal_images[..., 2]
    basis = torch.stack([torch.ones_like(nx), nx, ny, nz, nx * ny, nx * nz, ny * nz,
                         nx ** 2 - ny ** 2, 3.0 * nz ** 2 - 1.0], dim=-1)
    basis = basis * torch.tensor(SH_CONSTANT_FACTOR, dtype=basis.dtype, device=basis.device)
    with full_f32_matmul():
        return torch.einsum("bijk,bkc->bijc", basis, sh_coeff)


def add_pointlight(vertices: torch.Tensor, normals: torch.Tensor,
                   lights: torch.Tensor) -> torch.Tensor:
    """Point lighting (``renderer.py:208-220``): the mean over lights of
    (n·dir)·intensity, not clamped. vertices, normals (B, N, 3); lights
    (B, L, 6)."""
    pos = lights[:, :, :3]
    intensity = lights[:, :, 3:]
    d = pos[:, :, None, :] - vertices[:, None, :, :]          # (B, L, N, 3)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    ndl = (d * normals[:, None]).sum(dim=-1)
    shading = ndl[:, :, :, None] * intensity[:, :, None, :]
    return shading.mean(dim=1)


def process_uvcoords(uvcoords: torch.Tensor) -> torch.Tensor:
    """Raw obj vt coordinates (V', 2) in [0, 1] → the rasterizer's frame
    (V', 3): to [-1, 1], y negated, z = 1 (``renderer.py:102-103``)."""
    uv = uvcoords * 2.0 - 1.0
    return torch.cat([uv[:, :1], -uv[:, 1:], torch.ones_like(uv[:, :1])], dim=-1)


def render_textured(vertices: torch.Tensor, transformed_vertices: torch.Tensor,
                    faces: torch.Tensor, albedos: torch.Tensor,
                    uvcoords: torch.Tensor, uvfaces: torch.Tensor,
                    lights: Optional[torch.Tensor] = None,
                    light_type: str = "point", image_size: int = 224,
                    chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Textured render (``SRenderY.forward``, ``renderer.py:121-191``).

    vertices (B, V, 3) world mesh; transformed_vertices (B, V, 3)
    projected; faces (F, 3); albedos (B, Ht, Wt, 3) UV texture; uvcoords
    (V', 2) raw; uvfaces (F, 3); lights (B, 9, 3) SH or (B, L, 6) point or
    directional. Returns the reference's output dict, images NHWC."""
    batch = vertices.shape[0]
    tv = _shift_z(transformed_vertices)                      # ``renderer.py:135``

    fv_world = face_vertices(vertices, faces)
    normals = vertex_normals(vertices, faces)
    face_normals = face_vertices(normals, faces)
    t_normals = vertex_normals(tv, faces)
    t_face_normals = face_vertices(t_normals, faces)

    f_uv = process_uvcoords(uvcoords)[uvfaces]               # (F, 3, 3)
    f_uv = f_uv[None].expand((batch,) + f_uv.shape)
    attributes = torch.cat([f_uv, t_face_normals.detach(), fv_world.detach(), face_normals],
                           dim=-1)

    rendering, cover = rasterize(tv, faces, attributes, image_size, chunk)
    alpha = cover[..., None].detach()

    grid = rendering[..., 0:2]                               # uv (x, y)
    albedo_images = grid_sample(albedos, grid, align_corners=False)

    pos_mask = (rendering[..., 5:6].detach() < -0.05).to(rendering.dtype)
    normal_images = rendering[..., 9:12]
    if lights is None:
        images = albedo_images
        shading_images = images.detach() * 0.0
    else:
        if lights.shape[1] == 9:                             # SH coefficients
            shading_images = add_shlight(normal_images, lights)
        elif light_type == "point":
            vert_images = rendering[..., 6:9].detach().reshape(batch, -1, 3)
            shading = add_pointlight(vert_images, normal_images.reshape(batch, -1, 3), lights)
            shading_images = shading.reshape(batch, image_size, image_size, 3)
        else:
            shading = add_directionlight(normal_images.reshape(batch, -1, 3), lights)
            shading_images = shading.reshape(batch, image_size, image_size, 3)
        images = albedo_images * shading_images

    return {
        "images": images * alpha,
        "albedo_images": albedo_images * alpha,
        "alpha_images": alpha,
        "pos_mask": pos_mask,
        "shading_images": shading_images,
        "grid": grid,
        "normals": normals,
        "normal_images": normal_images * alpha,
        "transformed_normals": t_normals,
    }


def world2uv(vertices: torch.Tensor, faces: torch.Tensor, uvcoords: torch.Tensor,
             uvfaces: torch.Tensor, uv_size: int = 256,
             chunk: Optional[int] = None) -> torch.Tensor:
    """Per-vertex world positions rasterized into UV space
    (``renderer.py:331-340``): vertices (B, V, D) (D = 3; any D
    interpolates channel by channel), faces (F, 3), uvcoords (V', 2) raw,
    uvfaces (F, 3) → (B, uv, uv, D)."""
    batch = vertices.shape[0]
    fv = face_vertices(vertices, faces)
    uvc3 = process_uvcoords(uvcoords)
    uv_pos = uvc3[None].expand((batch,) + uvc3.shape)
    out, _ = rasterize(uv_pos, uvfaces, fv, uv_size, chunk)
    return out


def generate_triangles(h: int, w: int, margin_x: int = 2, margin_y: int = 5) -> np.ndarray:
    """The dense triangulation of an (h, w) UV map (``util.py:155-170``),
    x-major and wound as the reference's. Host numpy, (F, 3) int32."""
    xs, ys = np.meshgrid(np.arange(margin_x, w - 1 - margin_x),
                         np.arange(margin_y, h - 1 - margin_y), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    t0 = np.stack([ys * w + xs, ys * w + xs + 1, (ys + 1) * w + xs], axis=1)
    t1 = np.stack([ys * w + xs + 1, (ys + 1) * w + xs + 1, (ys + 1) * w + xs], axis=1)
    tris = np.stack([t0, t1], axis=1).reshape(-1, 3)
    return tris[:, [0, 2, 1]].astype(np.int32)


def _displaced_uv_vertices(uv_z, coarse_verts, coarse_normals, faces, assets, chunk):
    uv = uv_z.shape[1]
    # positions and normals share one UV rasterization (the same faces over
    # the same atlas; each channel interpolates on its own). Both are
    # detached, as the reference's (``deca.py:119``): the gradient flows
    # through uv_z alone
    both = world2uv(torch.cat([coarse_verts, coarse_normals], dim=-1), faces,
                    assets["uvcoords"], assets["uvfaces"], uv, chunk).detach()
    uv_cv, uv_cn = both[..., :3], both[..., 3:]
    uv_z = uv_z * assets["uv_face_eye_mask"]
    fixed = assets["fixed_uv_dis"][None, :, :, None]
    detail_verts = uv_cv + uv_z * uv_cn + fixed * uv_cn
    dense_faces = assets.get("dense_faces")
    if dense_faces is None:
        dense_faces = torch.as_tensor(generate_triangles(uv, uv), dtype=torch.int64,
                                      device=uv_z.device)
    return detail_verts.reshape(uv_z.shape[0], -1, 3), dense_faces, uv


def displacement2normal(uv_z: torch.Tensor, coarse_verts: torch.Tensor,
                        coarse_normals: torch.Tensor, faces: torch.Tensor,
                        assets: Assets, chunk: Optional[int] = None) -> torch.Tensor:
    """Displacement map (B, uv, uv, 1) → detail normal map (B, uv, uv, 3)
    (``deca.py:114-126``)."""
    dense_verts, dense_faces, uv = _displaced_uv_vertices(
        uv_z, coarse_verts, coarse_normals, faces, assets, chunk)
    return vertex_normals(dense_verts, dense_faces).reshape(uv_z.shape[0], uv, uv, 3)


def displacement2vertex(uv_z: torch.Tensor, coarse_verts: torch.Tensor,
                        coarse_normals: torch.Tensor, faces: torch.Tensor,
                        assets: Assets, chunk: Optional[int] = None):
    """Displacement map → (dense detail vertices (B, uv·uv, 3), dense faces)
    (``deca.py:128-141``)."""
    dense_verts, dense_faces, _ = _displaced_uv_vertices(
        uv_z, coarse_verts, coarse_normals, faces, assets, chunk)
    return dense_verts, dense_faces


def visofp(transformed_normals: torch.Tensor, flame) -> torch.Tensor:
    """68-landmark visibility from the normals' z (``deca.py:143-148``):
    (B, 68, 1), 1 where the landmark's normal z < 0.1."""
    from .flame import select_3d68
    return (select_3d68(flame, transformed_normals)[:, :, 2:] < 0.1).to(
        transformed_normals.dtype)


def load_obj_uv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The UV atlas of a Wavefront obj (in place of pytorch3d's ``load_obj``,
    ``renderer.py:86-89``): (uvcoords (V', 2) float32, uvfaces (F, 3) int32,
    0-based, from the faces' v/vt[/vn] tuples). Polygons are fan
    triangulated as pytorch3d does; faces without vt indices raise."""
    uvcoords, uvfaces = [], []
    n_face_lines = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "vt":
                uvcoords.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f":
                n_face_lines += 1
                idx = []
                for vert in parts[1:]:
                    fields = vert.split("/")
                    if len(fields) > 1 and fields[1]:
                        idx.append(int(fields[1]) - 1)
                if 0 < len(idx) < 3:
                    raise ValueError(f"{path}: face with fewer than 3 vt indices")
                for i in range(1, len(idx) - 1):
                    uvfaces.append([idx[0], idx[i], idx[i + 1]])
    if n_face_lines and not uvfaces:
        raise ValueError(f"{path}: faces carry no vt texture indices — "
                         "the obj has no UV atlas to render with")
    return np.asarray(uvcoords, np.float32), np.asarray(uvfaces, np.int32)


def _assets(uvcoords, uvfaces, mask, fixed, uv_size, device) -> Assets:
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {
        "uvcoords": torch.as_tensor(uvcoords, dtype=torch.float32).to(dev),
        "uvfaces": torch.as_tensor(uvfaces).to(device=dev, dtype=torch.int64),
        "uv_face_eye_mask": torch.as_tensor(mask, dtype=torch.float32).to(dev),
        "fixed_uv_dis": torch.as_tensor(fixed, dtype=torch.float32).to(dev),
        "dense_faces": torch.as_tensor(generate_triangles(uv_size, uv_size),
                                       dtype=torch.int64).to(dev),
    }


def load_render_assets(obj_path: str, uv_face_eye_mask_path: Optional[str] = None,
                       fixed_displacement_path: Optional[str] = None,
                       uv_size: int = 256, device=None) -> Assets:
    """The UV topology the reference reads in ``SRenderY.__init__`` and
    ``DECA.__init__`` (``renderer.py:86-107``, ``deca.py:53-65``):
    ``head_template.obj`` (vt and f lines), ``uv_face_eye_mask.png``
    (resized with Pillow's default filter, thresholded at 0.5) and
    ``fixed_displacement_256.npy``; a missing optional file gives an
    all-ones mask or a zero displacement. Tensors on ``device`` (the CPU
    when None)."""
    uvcoords, uvfaces = load_obj_uv(obj_path)
    if uv_face_eye_mask_path is not None:
        from PIL import Image
        m = np.asarray(Image.open(uv_face_eye_mask_path).convert("L").resize(
            (uv_size, uv_size)), np.float32) / 255.0
        mask = (m > 0.5).astype(np.float32)[..., None]
    else:
        mask = np.ones((uv_size, uv_size, 1), np.float32)
    if fixed_displacement_path is not None:
        fixed = np.load(fixed_displacement_path).astype(np.float32)
    else:
        fixed = np.zeros((uv_size, uv_size), np.float32)
    return _assets(uvcoords, uvfaces, mask, fixed, uv_size, device)


def synthetic_render_assets(generator: torch.Generator, n_faces: int, uv_size: int = 256,
                            n_uv_verts: int = 64, device=None) -> Assets:
    """A random UV topology for tests and runs without the user's download
    (one texture triple a mesh face; uvcoords U(0.05, 0.95)), drawn from
    ``generator`` with the JAX package's distributions."""
    uvcoords = 0.05 + 0.9 * torch.rand((n_uv_verts, 2), generator=generator)
    uvfaces = torch.randint(0, n_uv_verts, (n_faces, 3), generator=generator)
    return _assets(uvcoords, uvfaces, np.ones((uv_size, uv_size, 1), np.float32),
                   np.zeros((uv_size, uv_size), np.float32), uv_size, device)


def _project(points: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection with y and z flipped (``deca.py:175``)."""
    from ...geometry.rotations import batch_orth_proj
    p = batch_orth_proj(points, cam)
    return torch.cat([p[:, :, :1], -p[:, :, 1:]], dim=2)


def decode_deca(deca, codedict: Dict[str, torch.Tensor], assets: Assets,
                image_size: int = 224, uv_size: int = 256, use_tex: bool = False,
                draw_landmarks: bool = True, chunk: Optional[int] = None):
    """The reference's visualization decode (``deca.py:160-227``): FLAME
    decode → textured render with SH light → detail normals from the
    displacement map → shape and shape-detail overlays → UV texture
    extraction.

    deca: a :class:`DECA` with ``flame`` and ``D_detail`` (and ``flametex``
    for ``use_tex``); codedict: ``deca_encode(..., with_detail=True)``'s
    dict plus ``images`` (B, S, S, 3) in [0, 1]; assets: as
    :func:`load_render_assets`. Returns (opdict, visdict) with the
    reference's keys, NHWC. ``draw_landmarks`` draws the landmark overlays
    on the host; without it visdict carries the landmark arrays."""
    from .deca import detail_generator_forward
    from .flame import flame_forward, flametex_forward

    if deca.flame is None or deca.D_detail is None:
        raise ValueError("decode_deca needs a DECA built with FLAME and with_detail=True")
    images = codedict["images"]
    batch = images.shape[0]
    fl = deca.flame
    cam = codedict["cam"]

    verts, landmarks2d, landmarks3d = flame_forward(
        fl, codedict["shape"], codedict["exp"], codedict["pose"])
    uv_z = detail_generator_forward(deca.D_detail, torch.cat(
        [codedict["pose"][:, 3:], codedict["exp"], codedict["detail"]], dim=1))
    if use_tex:
        albedo = flametex_forward(deca.flametex, codedict["tex"])
    else:
        albedo = torch.zeros((batch, uv_size, uv_size, 3), dtype=verts.dtype,
                             device=verts.device)

    half = image_size / 2.0
    landmarks2d = _project(landmarks2d, cam)[:, :, :2] * half + half
    landmarks3d = _project(landmarks3d, cam) * half + half
    trans_verts = _project(verts, cam)

    ops = render_textured(verts, trans_verts, fl.faces, albedo, assets["uvcoords"],
                          assets["uvfaces"], lights=codedict["light"],
                          image_size=image_size, chunk=chunk)
    # the reference's renders add 10 to z IN PLACE (``renderer.py:135,255``),
    # so each later call gets a shifted copy and opdict carries z + 30
    trans_verts = _shift_z(trans_verts)
    uv_detail_normals = displacement2normal(uv_z, verts, ops["normals"], fl.faces,
                                            assets, chunk)
    uv_shading = add_shlight(uv_detail_normals, codedict["light"])
    uv_texture = albedo * uv_shading

    lm3d_vis = visofp(ops["transformed_normals"], fl)
    landmarks3d = torch.cat([landmarks3d, lm3d_vis], dim=2)

    shape_images = render_shape(verts, trans_verts, fl.faces, image_size=image_size,
                                chunk=chunk)
    trans_verts = _shift_z(trans_verts)
    detail_normal_images = grid_sample(uv_detail_normals, ops["grid"],
                                       align_corners=False) * ops["alpha_images"]
    shape_detail_images = render_shape(verts, trans_verts, fl.faces,
                                       detail_normal_images=detail_normal_images,
                                       image_size=image_size, chunk=chunk)
    trans_verts = _shift_z(trans_verts)

    uv_pverts = world2uv(trans_verts, fl.faces, assets["uvcoords"], assets["uvfaces"],
                         uv_size, chunk)
    uv_gt = grid_sample(images, uv_pverts[..., :2], align_corners=False)
    mask = assets["uv_face_eye_mask"]
    if use_tex:
        uv_texture_gt = uv_gt * mask + uv_texture * (1.0 - mask) * 0.7
    else:
        uv_texture_gt = uv_gt * mask + torch.ones_like(uv_gt) * (1.0 - mask) * 0.7

    opdict = {
        "vertices": verts,
        "normals": ops["normals"],
        "transformed_vertices": trans_verts,
        "landmarks2d": landmarks2d,
        "landmarks3d": landmarks3d,
        "uv_detail_normals": uv_detail_normals,
        "uv_texture_gt": uv_texture_gt,
        "displacement_map": uv_z + assets["fixed_uv_dis"][None, :, :, None],
    }
    if use_tex:
        opdict["albedo"] = albedo
        opdict["uv_texture"] = uv_texture

    if draw_landmarks:
        from ...utils.visualization import vis_landmarks
        host = images.detach().cpu().numpy()
        lm2d_vis = torch.as_tensor(vis_landmarks(
            host, landmarks2d.detach().cpu().numpy(), is_scale=False), dtype=images.dtype,
            device=images.device)
        lm3d_vis_img = torch.as_tensor(vis_landmarks(
            host, landmarks3d.detach().cpu().numpy(), is_scale=False), dtype=images.dtype,
            device=images.device)
    else:
        lm2d_vis, lm3d_vis_img = landmarks2d, landmarks3d
    visdict = {
        "inputs": images,
        "landmarks2d": lm2d_vis,
        "landmarks3d": lm3d_vis_img,
        "shape_images": shape_images,
        "shape_detail_images": shape_detail_images,
    }
    if use_tex:
        visdict["rendered_images"] = ops["images"]
    return opdict, visdict


def shape_visualization(deca, codedict: Dict[str, torch.Tensor],
                        images: Optional[torch.Tensor] = None,
                        image_size: int = 224, chunk: Optional[int] = None) -> torch.Tensor:
    """The shape overlay of ``decode_deca`` (``deca.py:160-189``): FLAME
    decode → projection with the y/z flip (kept unscaled) → ``render_shape``
    over ``images``. codedict: {shape, exp, pose, cam}. Returns
    (B, S, S, 3)."""
    from .flame import flame_forward
    verts, _, _ = flame_forward(deca.flame, codedict["shape"], codedict["exp"],
                                codedict["pose"])
    return render_shape(verts, _project(verts, codedict["cam"]), deca.flame.faces,
                        images=images, image_size=image_size, chunk=chunk)
