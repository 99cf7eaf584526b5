"""The port's DECA renderer (``models/deca/render.py``) and its samplers
(``models/nn.py::{grid_sample, affine_warp}``) against the JAX package on
the CPU.

Inputs are made with numpy from seeds: the JAX package's
``synthetic_flame_params`` (256 vertices, 400 faces) carried into the port
with ``flame_from_jax``, a closed sphere mesh where a surface helps, images
of 32-48², a UV map of 32² (256² where the detail decoder fixes it), and a
face chunk of 7, which divides no face count here.

Tolerances: values rtol 1e-5, atol 1e-5·max|JAX|. Coverage, and the masks
thresholded from rendered values (``pos_mask``), are compared exactly
except at pixels where a face's smallest barycentric coordinate lies
within ``EDGE_EPS`` of 0, or two covering faces' depths within
``EDGE_EPS`` (:func:`edge_pixels`): there the two packages' rounding may
flip a pixel. The flipped pixels are counted and must lie among those and
number at most ``MAX_FLIPS`` of a map; every other pixel is held at the
value tolerance. On this CPU both counts read 0.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylegan_directions_face_reenactment_tpu.models import nn as jnn
from stylegan_directions_face_reenactment_tpu.models.deca import flame as jf
from stylegan_directions_face_reenactment_tpu.models.deca import render as jr

from stylegan_directions_face_reenactment_tpu_torch.models import nn as pnn
from stylegan_directions_face_reenactment_tpu_torch.models.deca import render as pr
from stylegan_directions_face_reenactment_tpu_torch.models.deca.deca import DECA
from stylegan_directions_face_reenactment_tpu_torch.models.deca.flame import FLAMETex
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    detail_generator_from_jax, flame_from_jax)

from torch_face_zoo import to_np
from torch_render_world import (jax_detail_params, normals64, smooth_texture_space, sphere,
                                sphere_flame)
from torch_threads import _threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5           # atol relative to max|JAX output|
EDGE_EPS = 1e-4                   # barycentric coordinate or depth gap
MAX_FLIPS = 0.005                 # of a map's pixels
CHUNK = 7
B = 2


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


def jx(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of the JAX package as one compiled program
    (eager JAX compiles op by op); array keywords are traced, the others
    static."""
    arrays = (np.ndarray, jax.Array)
    static = tuple(sorted((k, v) for k, v in kwargs.items() if not isinstance(v, arrays)))
    return _jitted(fn, static)(*args, **{k: v for k, v in kwargs.items() if isinstance(v, arrays)})


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL):
    got, want = host(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(np.abs(want).max(), 1e-30))


def close_but_flips(got, want, edges, rtol=RTOL, atol=ATOL, scale=None):
    """Values within the tolerance except at flipped pixels, which must be
    edge pixels and at most MAX_FLIPS of the map. got/want (B, S, S[, D]);
    edges (B, S, S); ``scale`` (B, S, S) multiplies the atol pixel by pixel
    (:func:`normal_scale`). Returns the flip count."""
    got, want = host(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = atol * max(np.abs(want).max(), 1e-30)
    if scale is not None:
        tol = tol * scale.reshape(scale.shape + (1,) * (want.ndim - scale.ndim))
    bad = np.abs(got - want) > tol + rtol * np.abs(want)
    if bad.ndim == 4:
        bad = bad.any(-1)
    assert not (bad & ~edges).any(), f"{int((bad & ~edges).sum())} pixels off an edge disagree"
    assert bad.sum() <= MAX_FLIPS * bad.size, f"{int(bad.sum())} flipped pixels"
    return int(bad.sum())


def normal_scale(verts, faces):
    """(B, V): how far normalizing a vertex normal magnifies the rounding of
    its sum (float64): the norms of the face cross products added at the
    vertex over the norm of their sum, at least 1. The two packages add the
    same terms in another order, so their unnormalized sums agree relative
    to the terms, and the normals relative to this."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    fv = v[:, f]
    n = np.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0])
    acc = np.zeros_like(v)
    mag = np.zeros(v.shape[:2])
    for k in range(3):
        np.add.at(acc, (slice(None), f[:, k]), n)
        np.add.at(mag, (slice(None), f[:, k]), np.linalg.norm(n, axis=-1))
    return np.maximum(1.0, mag / np.maximum(np.linalg.norm(acc, axis=-1), 1e-30))


def raster64(verts, faces, size):
    """The rasterizer's arithmetic in float64 for the tests' exemptions, per
    batch entry: (barycentrics (3, F, S, S) with degenerate faces at -inf,
    depths (F, S, S))."""
    coords = 2.0 * (np.arange(size) + 0.5) / size - 1.0
    px, py = coords[None, None, :], coords[None, :, None]
    for v in np.asarray(verts, np.float64)[:, np.asarray(faces)]:    # (F, 3, 3)
        x, y, z = (v[:, :, k][:, :, None, None] for k in range(3))
        area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
                - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
        ok = np.abs(area) > 1e-12

        def edge(i, j):
            return (x[:, i] - px) * (y[:, j] - py) - (x[:, j] - px) * (y[:, i] - py)

        bary = np.where(ok, np.stack([edge(1, 2), edge(2, 0), edge(0, 1)])
                        / np.where(ok, area, 1.0), -np.inf)
        yield bary, np.where(ok, (bary * z.transpose(1, 0, 2, 3)).sum(0), np.inf)


def edge_pixels(verts, faces, size, eps=EDGE_EPS):
    """(B, S, S) pixels whose coverage or winner the two packages' rounding
    could flip: within eps of a face's edge in barycentric terms, or where
    the two nearest covering faces' depths lie within eps."""
    out = []
    for bary, zs in raster64(verts, faces, size):
        bmin = bary.min(0)
        zs = np.where(bmin >= -eps, zs, np.inf)
        two = np.sort(zs, axis=0)[:2]
        gap = np.where(np.isfinite(two[1]), two[1] - np.where(np.isfinite(two[1]), two[0], 0.0),
                       np.inf)
        out.append((np.abs(bmin) <= eps).any(0) | (gap <= eps))
    return np.stack(out)


def interp64(verts, faces, size, attrs):
    """(B, S, S, D) the nearest covering face's interpolation of per-vertex
    attrs (B, V, D) in float64, and the coverage (B, S, S)."""
    vals, cover = [], []
    for b, (bary, zs) in enumerate(raster64(verts, faces, size)):
        zs = np.where(bary.min(0) >= 0, zs, np.inf)
        win = zs.argmin(0)                                        # (S, S)
        wb = np.take_along_axis(bary, win[None, None], 1)[:, 0]   # (3, S, S)
        corner = np.asarray(attrs, np.float64)[b][np.asarray(faces)[win]]   # (S, S, 3, D)
        vals.append(np.einsum("kij,ijkd->ijd", wb, corner))
        cover.append(np.isfinite(zs.min(0)))
    return np.stack(vals), np.stack(cover)


def random_mesh(seed, batch=B, n_verts=256, n_faces=400, depth=(1.0, 3.0)):
    rs = np.random.RandomState(seed)
    verts = rs.uniform(-1.0, 1.0, (batch, n_verts, 3)).astype(np.float32)
    verts[..., 2] = rs.uniform(*depth, (batch, n_verts))
    faces = rs.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    return verts, faces


@pytest.fixture(scope="module")
def flame():
    j = to_np(jax.jit(jf.synthetic_flame_params)(jax.random.PRNGKey(7)))
    return j, flame_from_jax(j, device="cpu")


# --- rasterizer -------------------------------------------------------------

@pytest.mark.parametrize("chunk", [CHUNK, None])
def test_rasterize_matches_jax(chunk):
    verts, faces = random_mesh(0)
    attrs = np.random.RandomState(1).randn(B, len(faces), 3, 5).astype(np.float32)
    size = 40
    # eager, as the JAX package runs it: compiled whole, XLA contracts the
    # barycentric products into FMAs, and a sliver's interpolation moves by
    # 1e-4 (both roundings are right; the tolerance is for the same ones)
    want, want_cover = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
                                    size, CHUNK)
    got, got_cover = pr.rasterize(t(verts), t(faces, torch.int64), t(attrs), size, chunk)
    edges = edge_pixels(verts, faces, size)
    flips = host(got_cover) != np.asarray(want_cover)
    assert not (flips & ~edges).any() and flips.sum() <= MAX_FLIPS * flips.size
    close_but_flips(got, want, edges)
    assert 0.3 < float(np.asarray(want_cover).mean()) < 1.0


def test_rasterize_ties_first_face_wins():
    """Each face duplicated at the same depth with other attributes, the
    duplicates' order shuffled across chunks: the first index wins on both
    sides."""
    verts, faces = random_mesh(2, n_faces=40)
    rs = np.random.RandomState(3)
    faces = np.concatenate([faces, faces])[rs.permutation(80)]
    attrs = rs.randn(B, 80, 3, 2).astype(np.float32)
    size = 24
    first = {}
    for i, f in enumerate(map(tuple, faces)):
        first.setdefault(f, i)
    for chunk in (CHUNK, 80):
        want, _ = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
                               size, chunk)
        got, _ = pr.rasterize(t(verts), t(faces, torch.int64), t(attrs), size, chunk)
        close(got, want)
    # the winner is the first of each pair: zeroing the later copies' attributes
    # changes nothing
    later = np.array([first[tuple(f)] != i for i, f in enumerate(faces)])
    masked = attrs.copy()
    masked[:, later] = 0.0
    got2, _ = pr.rasterize(t(verts), t(faces, torch.int64), t(masked), size, CHUNK)
    np.testing.assert_array_equal(host(got2), host(got))


def test_rasterize_chunk_invariance():
    verts, faces = random_mesh(4)
    attrs = np.random.RandomState(5).randn(B, len(faces), 3, 4).astype(np.float32)
    runs = [pr.rasterize(t(verts), t(faces, torch.int64), t(attrs), 32, c)
            for c in (CHUNK, 64, 400, None)]
    for vals, cover in runs[1:]:
        assert torch.equal(vals, runs[0][0]) and torch.equal(cover, runs[0][1])
    assert pr.raster_chunk(16, 256) == 256 and pr.raster_chunk(1, 256, "cpu") == 64


def test_mesh_helpers_match_jax():
    verts, faces = random_mesh(6, n_faces=300)
    close(pr.face_vertices(t(verts), t(faces, torch.int64)),
          jx(jr.face_vertices, verts, faces))
    want = jx(jr.vertex_normals, verts, faces)
    close(pr.vertex_normals(t(verts), t(faces, torch.int64)), want)
    # a vertex no face uses keeps the 1e-6 floor: zero, not NaN
    loose = np.concatenate([verts, np.ones((B, 1, 3), np.float32)], axis=1)
    got = pr.vertex_normals(t(loose), t(faces, torch.int64))
    assert torch.equal(got[:, -1], torch.zeros(B, 3))


# --- lights -------------------------------------------------------------------

def test_lights_match_jax():
    rs = np.random.RandomState(8)
    normals = rs.randn(B, 50, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    pts = rs.randn(B, 50, 3).astype(np.float32)
    lights = rs.randn(B, 3, 6).astype(np.float32)
    nimg = normals[:, :36].reshape(B, 6, 6, 3)
    sh = rs.randn(B, 9, 3).astype(np.float32)
    uv = rs.rand(20, 2).astype(np.float32)

    def lights_of(m, normals, pts, lights, nimg, sh, uv):
        return (m.default_lights(B), m.add_directionlight(normals, m.default_lights(B)),
                m.add_directionlight(normals, lights), m.add_pointlight(pts, normals, lights),
                m.add_shlight(nimg, sh), m.process_uvcoords(uv))

    want = jax.jit(functools.partial(lights_of, jr))(normals, pts, lights, nimg, sh, uv)
    got = lights_of(pr, *(t(a) for a in (normals, pts, lights, nimg, sh, uv)))
    for g, w in zip(got, want):
        close(g, w)
    assert pr.SH_CONSTANT_FACTOR == jr.SH_CONSTANT_FACTOR
    for h, w in ((16, 16), (32, 24)):
        np.testing.assert_array_equal(pr.generate_triangles(h, w), jr.generate_triangles(h, w))


# --- renders ------------------------------------------------------------------

def _shape_edges(tverts, faces, size, thresh):
    """Edge pixels of render_shape and render_textured: the rasterizer's,
    and pixels whose transformed normal's z lies within EDGE_EPS of the
    pos_mask threshold."""
    tv = np.asarray(tverts, np.float64) + np.array([0.0, 0.0, 10.0])
    nmap, _ = interp64(tv, faces, size, normals64(tv, faces))
    return edge_pixels(tv, faces, size) | (np.abs(nmap[..., 2] - thresh) <= EDGE_EPS)


@pytest.mark.parametrize("case", ["plain", "images", "detail_normals"])
def test_render_shape_matches_jax(case):
    verts, tverts, faces, _, _ = sphere()
    size = 40
    rs = np.random.RandomState(9)
    kw = {}
    if case == "images":
        kw["images"] = rs.rand(B, size, size, 3).astype(np.float32)
    if case == "detail_normals":
        dn = rs.randn(B, size, size, 3).astype(np.float32)
        kw["detail_normal_images"] = dn / np.linalg.norm(dn, axis=-1, keepdims=True)
    want = jx(jr.render_shape, verts, tverts, faces, image_size=size, chunk=CHUNK, **kw)
    kw_p = {k: t(v) for k, v in kw.items()}
    got = pr.render_shape(t(verts), t(tverts), t(faces, torch.int64), image_size=size,
                          chunk=CHUNK, **kw_p)
    close_but_flips(got, want, _shape_edges(tverts, faces, size, 0.15))
    assert np.asarray(want).max() > 0.1


@pytest.mark.parametrize("lights", ["sh", "point", "directional", "none"])
def test_render_textured_matches_jax(lights):
    verts, tverts, faces, _, _ = sphere()
    rs = np.random.RandomState(10)
    size = 32
    _, _, _, uvcoords, uvfaces = sphere()
    tex = rs.rand(B, 16, 16, 3).astype(np.float32)
    light = {"sh": rs.randn(B, 9, 3), "point": rs.randn(B, 3, 6),
             "directional": rs.randn(B, 5, 6), "none": None}[lights]
    light_type = "point" if lights == "point" else "directional"
    kw = {"light_type": light_type, "image_size": size, "chunk": CHUNK}
    want = jx(jr.render_textured, verts, tverts, faces, tex, uvcoords, uvfaces,
              lights=None if light is None else light.astype(np.float32), **kw)
    got = pr.render_textured(t(verts), t(tverts), t(faces, torch.int64), t(tex), t(uvcoords),
                             t(uvfaces, torch.int64),
                             lights=None if light is None else t(light, torch.float32), **kw)
    assert set(got) == set(want)
    edges = _shape_edges(tverts, faces, size, -0.05)
    for k in ("images", "albedo_images", "alpha_images", "pos_mask", "shading_images",
              "grid", "normal_images"):
        close_but_flips(got[k], want[k], edges)
    close(got["normals"], want["normals"])
    close(got["transformed_normals"], want["transformed_normals"])


def _sphere_assets(uv_size, rs):
    """The sphere's atlas and assets at uv_size, with a random eye mask and
    fixed displacement."""
    _, _, _, uvcoords, uvfaces = sphere()
    mask = (rs.rand(uv_size, uv_size, 1) > 0.3).astype(np.float32)
    fixed = (0.01 * rs.randn(uv_size, uv_size)).astype(np.float32)
    dense = jr.generate_triangles(uv_size, uv_size)
    j = {"uvcoords": uvcoords, "uvfaces": uvfaces, "uv_face_eye_mask": mask,
         "fixed_uv_dis": fixed, "dense_faces": dense}
    p = {k: t(v, torch.int64 if k in ("uvfaces", "dense_faces") else None)
         for k, v in j.items()}
    return {k: jnp.asarray(v) for k, v in j.items()}, p


@functools.lru_cache(maxsize=None)
def sphere_atlas_masks(uv_size):
    """The sphere atlas's (edge texels, border texels) at uv_size, (1, uv,
    uv) each. Border: texels within one of both a covered and an uncovered
    texel, where the dense mesh joins uncovered texels (at the origin) to
    the surface and its normals take the rounding of the surface's short
    edges against long ones."""
    _, _, _, uvcoords, uvfaces = sphere()
    uv = np.concatenate([uvcoords * 2.0 - 1.0, np.ones_like(uvcoords[:, :1])], axis=1)
    uv[:, 1] *= -1.0
    _, cover = interp64(uv[None], uvfaces, uv_size, np.zeros((1, len(uv), 1)))
    return edge_pixels(uv[None], uvfaces, uv_size), grown(cover) & grown(~cover)


def grown(edges):
    """edges and their 8 neighbours: a flipped texel moves the dense normals
    of the texels around it too."""
    out = edges.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= np.roll(edges, (dy, dx), axis=(1, 2))
    return out


def test_world2uv_and_displacements_match_jax():
    verts, _, faces, _, _ = sphere()
    rs = np.random.RandomState(11)
    uv_size = 32
    ja, pa = _sphere_assets(uv_size, rs)
    normals = normals64(verts, faces).astype(np.float32)
    uv_z = (0.1 * rs.randn(B, uv_size, uv_size, 1)).astype(np.float32)
    edges, border = sphere_atlas_masks(uv_size)
    near = grown(edges | border)

    want = jx(jr.world2uv, verts, faces, ja["uvcoords"], ja["uvfaces"], uv_size=uv_size,
              chunk=CHUNK)
    got = pr.world2uv(t(verts), t(faces, torch.int64), pa["uvcoords"], pa["uvfaces"], uv_size,
                      CHUNK)
    close_but_flips(got, want, edges)

    args_j = (uv_z, verts, normals, faces, ja)
    args_p = (t(uv_z), t(verts), t(normals), t(faces, torch.int64), pa)
    dv_p, df_p = pr.displacement2vertex(*args_p, chunk=CHUNK)
    dv_j, df_j = jx(jr.displacement2vertex, *args_j, chunk=CHUNK)
    close_but_flips(pr.displacement2normal(*args_p, chunk=CHUNK),
                    jx(jr.displacement2normal, *args_j, chunk=CHUNK), near,
                    scale=normal_scale(dv_j, df_j).reshape(B, uv_size, uv_size))
    close_but_flips(dv_p.reshape(B, uv_size, uv_size, 3),
                    np.asarray(dv_j).reshape(B, uv_size, uv_size, 3), edges)
    np.testing.assert_array_equal(host(df_p), np.asarray(df_j))


def test_visofp_matches_jax(flame):
    jfl, pfl = flame
    n = np.random.RandomState(12).randn(B, 256, 3).astype(np.float32)
    want = jx(jr.visofp, n, jfl)
    got = pr.visofp(t(n), pfl)
    np.testing.assert_array_equal(host(got), np.asarray(want))
    assert got.shape == (B, 68, 1)


# --- assets -------------------------------------------------------------------

def test_render_assets_match_jax(tmp_path):
    from PIL import Image
    obj = tmp_path / "head.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                   "vt 0.1 0.2\nvt 0.9 0.2\nvt 0.5 0.8\nvt 0.9 0.9\n"
                   "f 1/1/1 2/2/1 3/3/1\nf 2/2 4/4 3/3 1/1\n")
    rs = np.random.RandomState(13)
    mask_path = tmp_path / "mask.png"
    Image.fromarray((rs.rand(50, 50) * 255).astype(np.uint8)).save(mask_path)
    fixed_path = tmp_path / "fixed.npy"
    np.save(fixed_path, rs.randn(32, 32))
    want = jr.load_render_assets(str(obj), str(mask_path), str(fixed_path), uv_size=32)
    got = pr.load_render_assets(str(obj), str(mask_path), str(fixed_path), uv_size=32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(host(got[k]), np.asarray(want[k]))
    bare = pr.load_render_assets(str(obj), uv_size=16)
    assert bare["uv_face_eye_mask"].shape == (16, 16, 1) and float(bare["fixed_uv_dis"].abs().max()) == 0
    for a, b in zip(pr.load_obj_uv(str(obj)), jr.load_obj_uv(str(obj))):
        np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="vt"):
        pr.load_obj_uv(str(bad))
    syn = pr.synthetic_render_assets(torch.Generator().manual_seed(0), 400, uv_size=32,
                                     n_uv_verts=5118)
    assert syn["uvfaces"].shape == (400, 3) and int(syn["uvfaces"].max()) < 5118
    assert syn["dense_faces"].shape == (2 * (32 - 5) * (32 - 11), 3)
    assert 0.05 <= float(syn["uvcoords"].min()) and float(syn["uvcoords"].max()) <= 0.95


# --- decodes ------------------------------------------------------------------

@pytest.fixture(scope="module")
def deca_pair():
    return build_deca_pair()


def build_deca_pair():
    """The JAX bundle decode_deca reads (the sphere's FLAME, a decoder, a
    seeded texture space of 50 components) and the port's DECA holding the
    same, the decoder through ``detail_generator_from_jax``."""
    rs = np.random.RandomState(15)
    params = {"flame": sphere_flame(rs), "d_detail": jax_detail_params(rs),
              "flametex": smooth_texture_space(rs)}
    deca = DECA(flame_from_jax(params["flame"], device="cpu"), with_detail=True,
                flametex=FLAMETex(**params["flametex"]))
    deca.D_detail = detail_generator_from_jax(params["d_detail"], device="cpu")
    return params, deca


def _codedict(size, seed):
    rs = np.random.RandomState(seed)
    cam = np.stack([0.012 + 0.001 * rs.randn(B), 5.0 * rs.randn(B), 5.0 * rs.randn(B)], axis=1)
    cd = {"shape": rs.randn(B, 100), "exp": rs.randn(B, 50), "pose": 0.3 * rs.randn(B, 6),
          "cam": cam, "light": 0.3 * rs.randn(B, 9, 3), "tex": rs.randn(B, 50),
          "detail": rs.randn(B, 128), "images": rs.rand(B, size, size, 3)}
    return {k: v.astype(np.float32) for k, v in cd.items()}


@functools.partial(jax.jit, static_argnames=("size", "uv_size", "use_tex"))
def jax_decode_oracle(params, cd, assets, port, size, uv_size, use_tex):
    """JAX's ``decode_deca``, and its stages fed with the port's own
    intermediate results (``port``): the dense detail vertices and their
    normals, the textured render's grid, the renders that sample a map
    through the port's grid, and the UV texture. One compiled program a
    case."""
    faces = params["flame"]["faces"]
    op, vis = jr.decode_deca(params, cd, assets, image_size=size, uv_size=uv_size,
                             use_tex=use_tex, draw_landmarks=False, chunk=64)
    fixed = assets["fixed_uv_dis"][None, :, :, None]
    out = {"op": op, "vis": vis}
    out["dense"], _ = jr.displacement2vertex(op["displacement_map"] - fixed, op["vertices"],
                                             op["normals"], faces, assets, chunk=64)
    out["dense_normals"] = jr.vertex_normals(port["dense"], assets["dense_faces"])
    raw_tv = op["transformed_vertices"] - jnp.asarray([0.0, 0.0, 30.0])
    out["grid"] = jr.render_textured(op["vertices"], raw_tv, faces, jnp.zeros((B, 8, 8, 3)),
                                     assets["uvcoords"], assets["uvfaces"], image_size=size,
                                     chunk=64)["grid"]
    dni = jnn.grid_sample(port["uv_detail_normals"], port["grid"]) * port["alpha"]
    out["shape_detail_images"] = jr.render_shape(
        op["vertices"], raw_tv + jnp.asarray([0.0, 0.0, 20.0]), faces,
        detail_normal_images=dni, image_size=size, chunk=64)
    if use_tex:
        uv_texture = op["albedo"] * jr.add_shlight(port["uv_detail_normals"], cd["light"])
        uv_pverts = jr.world2uv(op["transformed_vertices"], faces, assets["uvcoords"],
                                assets["uvfaces"], uv_size, 64)
        uv_gt = jnn.grid_sample(cd["images"], uv_pverts[..., :2])
        mask = assets["uv_face_eye_mask"]
        out["uv_texture"] = uv_texture
        out["uv_texture_gt"] = uv_gt * mask + uv_texture * (1.0 - mask) * 0.7
        out["rendered_images"] = (jnn.grid_sample(port["albedo"], port["grid"])
                                  * jr.add_shlight(port["normal_images"], cd["light"])
                                  * port["alpha"])
    return out


@pytest.mark.parametrize("use_tex,draw", [(False, True), (True, False)])
def test_decode_deca_matches_jax(deca_pair, use_tex, draw):
    """Every opdict and visdict entry against JAX's ``decode_deca``. What is
    made from the detail normals is held stage by stage, each stage against
    JAX's function of the port's input to it: the dense detail vertices,
    then their normals (a normal moves by its vertices' rounding over the
    texels' spacing), and the renders that sample a map through the
    textured render's grid (where a map changes fast from texel to texel,
    as the detail normals do at the atlas's seam, the grid's rounding moves
    the sample past the tolerance), after the grid itself."""
    params, deca = deca_pair
    size, uv_size = 32, 256          # the detail decoder's map is 256²
    cd = _codedict(size, 16)
    rs = np.random.RandomState(17)
    _, _, _, uvcoords, uvfaces = sphere()
    assets_np = {"uvcoords": uvcoords, "uvfaces": uvfaces,
                 "uv_face_eye_mask": (rs.rand(uv_size, uv_size, 1) > 0.2).astype(np.float32),
                 "fixed_uv_dis": (0.01 * rs.randn(uv_size, uv_size)).astype(np.float32),
                 "dense_faces": jr.generate_triangles(uv_size, uv_size)}
    pa = {k: t(v, torch.int64 if k in ("uvfaces", "dense_faces") else None)
          for k, v in assets_np.items()}
    got_op, got_vis = pr.decode_deca(deca, {k: t(v) for k, v in cd.items()}, pa,
                                     image_size=size, uv_size=uv_size, use_tex=use_tex,
                                     draw_landmarks=draw)
    albedo = got_op["albedo"] if use_tex else torch.zeros(B, uv_size, uv_size, 3)
    ops = pr.render_textured(got_op["vertices"], pr._project(got_op["vertices"], t(cd["cam"])),
                             deca.flame.faces, albedo, pa["uvcoords"], pa["uvfaces"],
                             lights=t(cd["light"]), image_size=size)
    dense, dense_faces = pr.displacement2vertex(
        got_op["displacement_map"] - pa["fixed_uv_dis"][None, :, :, None], got_op["vertices"],
        got_op["normals"], deca.flame.faces, pa)
    port = {"dense": dense, "uv_detail_normals": got_op["uv_detail_normals"],
            "grid": ops["grid"], "alpha": ops["alpha_images"], "albedo": albedo,
            "normal_images": ops["normal_images"]}
    jax_in = jax.tree_util.tree_map(lambda a: jnp.asarray(host(a)), (params, cd, assets_np, port))
    want = jax_decode_oracle(*jax_in, size=size, uv_size=uv_size, use_tex=use_tex)
    want_op, want_vis = want["op"], want["vis"]
    if draw:
        from stylegan_directions_face_reenactment_tpu.utils.visualization import vis_landmarks
        for k in ("landmarks2d", "landmarks3d"):
            want_vis[k] = vis_landmarks(cd["images"], np.asarray(want_op[k]), is_scale=False)
    assert set(got_op) == set(want_op) and set(got_vis) == set(want_vis)

    img_edges = edge_pixels(np.asarray(want_op["transformed_vertices"]),
                            params["flame"]["faces"], size)
    uv_edges, uv_border = sphere_atlas_masks(uv_size)
    uv_near = grown(uv_edges | uv_border)
    for k in ("vertices", "normals", "transformed_vertices", "landmarks2d", "landmarks3d",
              "displacement_map") + (("albedo",) if use_tex else ()):
        close(got_op[k], want_op[k])
    grid_shape = (B, uv_size, uv_size, 3)
    close_but_flips(host(dense).reshape(grid_shape), np.asarray(want["dense"]).reshape(grid_shape),
                    uv_near)
    close_but_flips(got_op["uv_detail_normals"], np.reshape(want["dense_normals"], grid_shape),
                    uv_near, scale=normal_scale(host(dense), host(dense_faces)).reshape(grid_shape[:3]))
    close_but_flips(got_op["uv_detail_normals"], want_op["uv_detail_normals"], np.ones_like(uv_near))
    if use_tex:
        close(got_op["uv_texture"], want["uv_texture"])
        close_but_flips(got_op["uv_texture_gt"], want["uv_texture_gt"], uv_near)
    else:
        close_but_flips(got_op["uv_texture_gt"], want_op["uv_texture_gt"], uv_near)

    close(got_vis["inputs"], want_vis["inputs"])
    for k in ("landmarks2d", "landmarks3d"):
        if draw:        # drawn on the host from landmarks that agree to 1e-5 px
            np.testing.assert_array_equal(host(got_vis[k]), np.asarray(want_vis[k], np.float32))
        else:
            close(got_vis[k], want_vis[k])
    close_but_flips(got_vis["shape_images"], want_vis["shape_images"], img_edges)
    close_but_flips(ops["grid"], want["grid"], img_edges)
    close_but_flips(got_vis["shape_detail_images"], want["shape_detail_images"], img_edges)
    if use_tex:
        close_but_flips(got_vis["rendered_images"], want["rendered_images"], img_edges)
    assert float(np.asarray(want_vis["shape_images"]).max()) > 0.1
    # z + 30 in the returned vertices, as the reference's in-place shifts leave them
    raw = pr._project(got_op["vertices"], t(cd["cam"]))
    np.testing.assert_allclose(host(got_op["transformed_vertices"][..., 2] - raw[..., 2]), 30.0,
                               atol=1e-4)


@functools.partial(jax.jit, static_argnames=("size",))
def jax_shape_visualization(params, cd, images, size):
    return (jr.shape_visualization(params, cd, image_size=size),
            jr.shape_visualization(params, cd, images=images, image_size=size))


def test_shape_visualization_matches_jax(deca_pair):
    params, deca = deca_pair
    size = 48
    cd = _codedict(size, 18)
    shape_cd = {k: cd[k] for k in ("shape", "exp", "pose", "cam")}
    want = jax_shape_visualization(params, shape_cd, cd["images"], size=size)
    got = [pr.shape_visualization(deca, {k: t(v) for k, v in shape_cd.items()},
                                  images=images, image_size=size, chunk=CHUNK)
           for images in (None, t(cd["images"]))]
    verts = host(deca_flame_vertices(deca, shape_cd))
    edges = _shape_edges(host(pr._project(t(verts), t(shape_cd["cam"]))),
                         params["flame"]["faces"], size, 0.15)
    for g, w in zip(got, want):
        close_but_flips(g, w, edges)
    with pytest.raises(ValueError, match="with_detail"):
        pr.decode_deca(DECA(deca.flame), {}, {})


def deca_flame_vertices(deca, cd):
    from stylegan_directions_face_reenactment_tpu_torch.models.deca.flame import flame_forward
    return flame_forward(deca.flame, *(t(cd[k]) for k in ("shape", "exp", "pose")))[0]


# --- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    rs = np.random.RandomState(19)
    x = rs.rand(B, 12, 10, 3).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (B, 7, 9, 2)).astype(np.float32)
    close(pnn.grid_sample(t(x), t(grid), align_corners=align_corners),
          jx(jnn.grid_sample, x, grid, align_corners=align_corners))


@pytest.mark.parametrize("rows", [2, 3])
def test_affine_warp_matches_jax(rows):
    rs = np.random.RandomState(20 + rows)
    x = rs.rand(B, 20, 24, 3).astype(np.float32)
    ang = rs.uniform(-0.5, 0.5, B)
    s = rs.uniform(0.7, 1.4, B)
    theta = np.zeros((B, 3, 3), np.float32)
    theta[:, 0, 0], theta[:, 0, 1] = s * np.cos(ang), -s * np.sin(ang)
    theta[:, 1, 0], theta[:, 1, 1] = s * np.sin(ang), s * np.cos(ang)
    theta[:, :2, 2] = rs.uniform(-4, 4, (B, 2))
    theta[:, 2, 2] = 1.0
    theta = theta[:, :rows]
    close(pnn.affine_warp(t(x), t(theta), (16, 18)),
          jx(jnn.affine_warp, x, theta, out_hw=(16, 18)))
