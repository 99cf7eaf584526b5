"""Inputs shared by the port's renderer and detail-branch tests: a closed
sphere mesh with a UV atlas, FLAME arrays over it, a smooth texture space
of the real width and the JAX displacement decoder's parameters, all made
with numpy from seeds."""

import numpy as np


def normals64(verts, faces):
    """Vertex normals in float64 (the sum of the face normals, normalized)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    fv = v[:, f]
    n = np.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0])
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, (slice(None), f[:, k]), n)
    return acc / np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-6)


def sphere():
    """The closed UV sphere of ``tests/test_render.py::
    test_render_shape_sphere`` (radius 0.7, 72 vertices, 120 faces, wound
    outward), two poses of it in the world frame and the y/z-flipped
    projected frame, and its UV atlas: the (u, v) grid split at the seam,
    whose triangles tile [0.05, 0.95]² without overlapping (the UV
    rasterization has every z at 1, so overlapping UV triangles would tie
    in depth and the rounding of their barycentric sums would pick the
    winner)."""
    n_u, n_v = 12, 6
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(0.15 * np.pi, 0.85 * np.pi, n_v)
    pts = np.array([[np.cos(u) * np.sin(v) * 0.7, np.cos(v) * 0.7,
                     -np.sin(u) * np.sin(v) * 0.7] for v in vs for u in us], np.float32)
    faces, uvfaces = [], []
    for i in range(n_v - 1):
        for j in range(n_u):
            a, b = i * n_u + j, i * n_u + (j + 1) % n_u
            c, d = (i + 1) * n_u + j, (i + 1) * n_u + (j + 1) % n_u
            faces += [[a, b, c], [b, d, c]]
            ua, ub = i * (n_u + 1) + j, i * (n_u + 1) + j + 1
            uc, ud = ua + n_u + 1, ub + n_u + 1
            uvfaces += [[ua, ub, uc], [ub, ud, uc]]
    faces, uvfaces = np.asarray(faces, np.int32), np.asarray(uvfaces, np.int32)
    if (normals64(pts[None], faces)[0] * pts).sum() < 0:
        faces, uvfaces = faces[:, ::-1].copy(), uvfaces[:, ::-1].copy()
    grid = np.array([[j / n_u, i / (n_v - 1)] for i in range(n_v) for j in range(n_u + 1)])
    uvcoords = (0.05 + 0.9 * grid).astype(np.float32)
    rs = np.random.RandomState(5)
    verts = np.stack([pts, pts * 0.9 + 0.05 * rs.randn(*pts.shape).astype(np.float32)])
    return verts, verts * np.array([1.0, -1.0, -1.0], np.float32), faces, uvcoords, uvfaces


def sphere_flame(rs):
    """FLAME arrays over the sphere scaled to radius 70 (72 vertices, 120
    faces, its atlas): the renders see a closed surface, and the detail
    decoder's displacements (up to 0.01, random from texel to texel) stay
    small beside the texels' spacing (about 1.9), so the detail normals
    change slowly across texels, as a face's do. (Sampled at a coordinate
    one rounding apart, as two packages' bilinear samplers give, a map
    that changes by ~1 a texel moves by more than the tolerance.) Shape
    and pose blend shapes × 1e-3; skinning on the global joint alone
    (rigid); landmarks on random faces."""
    verts, _, faces, _, _ = sphere()
    n_v, n_f = verts.shape[1], faces.shape[0]

    def simplex(*shape):
        e = np.exp(rs.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    lbs_weights = np.zeros((n_v, 5), np.float32)
    lbs_weights[:, 0] = 1.0
    return {"v_template": 100.0 * verts[0], "shapedirs": (1e-3 * rs.randn(n_v, 3, 150)).astype(np.float32),
            "posedirs": (1e-3 * rs.randn(36, n_v * 3)).astype(np.float32),
            "j_regressor": simplex(5, n_v), "lbs_weights": lbs_weights, "faces": faces,
            "lmk_faces_idx": rs.randint(0, n_f, 51).astype(np.int32),
            "lmk_bary_coords": simplex(51, 3),
            "dynamic_lmk_faces_idx": rs.randint(0, n_f, (79, 17)).astype(np.int32),
            "dynamic_lmk_bary_coords": simplex(79, 17, 3),
            "full_lmk_faces_idx": rs.randint(0, n_f, 68).astype(np.int32),
            "full_lmk_bary_coords": simplex(68, 3)}


def smooth_texture_space(rs, n_tex=50):
    """A texture space of the real width (512²·3, n_tex components) whose
    mean and components are products of low sinusoids along each axis of
    the map, so the albedo changes slowly across texels, as a face's does."""
    u = np.linspace(0.0, 1.0, 512, dtype=np.float32)

    def fields(n, amp):                                       # (512, 512, n)
        fx, fy = rs.uniform(0.5, 3.0, (2, n)).astype(np.float32)
        px, py = rs.uniform(0, 2 * np.pi, (2, n)).astype(np.float32)
        return amp * (np.sin(2 * np.pi * u[:, None] * fy + py)[:, None, :]
                      * np.sin(2 * np.pi * u[:, None] * fx + px)[None, :, :])

    mean = 0.5 + fields(3, 0.2)
    basis = fields(3 * n_tex, 0.01).reshape(512, 512, 3, n_tex)
    return {"texture_mean": mean.reshape(1, -1), "texture_basis": basis.reshape(-1, n_tex)}


def jax_detail_params(rs):
    """``init_detail_generator``'s layout made with numpy: weights
    U(±1/sqrt(fan in)), small biases, batch norms at random statistics."""
    f32 = np.float32

    def conv(cin, cout):
        lim = 1.0 / np.sqrt(cin * 9)
        return {"weight": rs.uniform(-lim, lim, (3, 3, cin, cout)).astype(f32),
                "bias": (0.01 * rs.randn(cout)).astype(f32)}

    def bn(c):
        return {"scale": (1 + 0.1 * rs.randn(c)).astype(f32), "offset": (0.1 * rs.randn(c)).astype(f32),
                "mean": (0.1 * rs.randn(c)).astype(f32), "var": (0.5 + rs.rand(c)).astype(f32)}

    chans = ((128, 128), (128, 64), (64, 64), (64, 32), (32, 16))
    lim = 1.0 / np.sqrt(181)
    return {"l1": {"weight": rs.uniform(-lim, lim, (8192, 181)).astype(f32),
                   "bias": (0.01 * rs.randn(8192)).astype(f32)},
            "bn0": bn(128), "convs": [conv(a, b) for a, b in chans],
            "bns": [bn(b) for _, b in chans], "conv_out": conv(16, 1), "meta": {"out_scale": 0.01}}
