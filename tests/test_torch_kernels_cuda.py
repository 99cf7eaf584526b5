"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the serving path's shapes (voxceleb-256, channel
multiplier 1, a batch of 16; K3 at the 2DFAN4 hourglass shapes of a batch
of 16 and of 1) and, for the backward of K1 (down = 2 for the skip
upsamples) and K2, at the shapes of one PTI step (batch 1), in float32 and
bf16; the autograd Functions against autograd through the plain versions;
and the gradients of one PTI step of the voxceleb generator, kernel path on
the card against the plain path on the CPU.

These need a CUDA card and nvcc; they are marked ``cuda`` and skip
elsewhere (the fixture decides, so every worker collects the same tests).
Run them on the card with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` sets JAX up, and a machine for
the port need not have JAX.)

Tolerances: K1 and its backward at the serving and PTI shapes and the odd
sizes, bit for bit (each output sums its taps in the plain version's
order; dyadic taps); other float32 atol 1e-5 (the sums run in another
order than cuDNN's); K3 in float32 1e-5·max(1, max|plain|) (sums of up to 2304
products in another order); bf16 1e-2 relative to max(1, max|plain|) (one
bf16 rounding, 2^-8, on either side), the bias gradient of a bf16 input
at the bf16 bound too (a sum of bf16 dx, as the JAX package's); the PTI
step's gradients rtol 1e-3, atol 2e-3·max|gradient| of each tensor (cuDNN's
convolutions sum in another order than the CPU's through the whole
generator and LPIPS; read 5e-6 to 6.5e-4·max on an NVIDIA H100 80GB HBM3 at
700 W); the noise weights' (each one scalar summing g·noise over C·R²
pixels that largely cancel) as one vector, rtol 1e-3, atol 1e-2·max (read
6e-5 to 2.8e-3·max).
"""

import pytest
import torch

from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
    fused_bias_act_bwd_cuda, fused_bias_act_cuda, fused_leaky_relu,
    fused_leaky_relu_bwd_plain, fused_leaky_relu_plain)
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    fused_bias_act_calls, fused_conv_block_calls, pti_backward_calls, upfirdn2d_calls)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
    make_kernel, upfirdn2d, upfirdn2d_output_shape)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
    upfirdn2d_backward, upfirdn2d_bwd_cuda, upfirdn2d_cuda, upfirdn2d_fir)

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def exact(got, want):
    """Bit for bit: K1 sums each output's taps in the plain version's order."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


def check(got, want, f32_scaled=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        scale = max(1.0, float(want.abs().max())) if f32_scaled else 1.0
        assert err <= 1e-5 * scale, err
    else:
        assert err <= 1e-2 * max(1.0, float(want.float().abs().max())), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("call", upfirdn2d_calls(), ids=lambda c: c.name)
def test_upfirdn2d_kernel_matches_plain(card, call, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(call.shape, generator=g, device=card).to(dtype)
    k = make_kernel((1, 3, 3, 1), gain=4)
    before = upfirdn2d_cuda.launches
    got = upfirdn2d_fir(x, k, call.up, call.pad)
    assert upfirdn2d_cuda.launches == before + 1
    exact(got, upfirdn2d(x, k, up=call.up, pad=call.pad))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_upfirdn2d_second_call_reuses_its_plan(card, dtype):
    """A shape's launch plan is made on its first call and found on the
    next; another shape gets its own."""
    from stylegan_directions_face_reenactment_tpu_torch.ops import upfirdn2d_kernel as k1
    k = make_kernel((1, 3, 3, 1), gain=4)
    x = torch.randn(2, 3, 11, 11, device=card).to(dtype)
    upfirdn2d_cuda(x, k, 2, (2, 1))
    n, plan = len(k1._plans), k1.plan_for(x, k, 2, 1, (2, 1), "t")
    y = upfirdn2d_cuda(x.clone(), k, 2, (2, 1))
    assert len(k1._plans) == n and k1.plan_for(x, k, 2, 1, (2, 1), "t") is plan
    assert tuple(y.shape) == plan.out_shape
    upfirdn2d_cuda(torch.randn(2, 3, 12, 11, device=card).to(dtype), k, 2, (2, 1))
    assert len(k1._plans) == n + 1


@pytest.mark.parametrize("up,pad,taps", [(1, (2, 2), (1, 3, 3, 1)),
                                         (2, (1, 2), (1, 2, 1)),
                                         (1, (-1, 2), (1, 3, 3, 1))])
def test_upfirdn2d_kernel_odd_pads(card, up, pad, taps):
    x = torch.randn(2, 5, 13, 11, device=card)
    k = make_kernel(taps, gain=up ** 2)
    check(upfirdn2d_cuda(x, k, up, pad), upfirdn2d(x, k, up=up, pad=pad))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,up,pad", [((1, 3, 5, 9), 2, (2, 1)), ((3, 7, 31, 30), 1, (1, 1)),
                                          ((1, 1, 1, 1), 2, (2, 1)), ((2, 4, 66, 65), 1, (2, 2)),
                                          ((1, 2, 7, 5), 1, (1, 1, 2, 0))], ids=str)
def test_upfirdn2d_kernel_odd_sizes(card, shape, up, pad, dtype):
    """Planes whose rows are not 4-aligned or fill part of a block, forward
    and backward (down 2 where up is 2), bit for bit; inputs in eighths,
    so every sum is exact in any order."""
    k = make_kernel((1, 3, 3, 1), gain=4)
    gen = torch.Generator(device=card).manual_seed(11)

    def eighths(s):
        return (torch.randint(-64, 65, s, generator=gen, device=card) / 8).to(dtype)
    x = eighths(shape)
    y = upfirdn2d_cuda(x, k, up, pad)
    exact(y, upfirdn2d(x, k, up=up, pad=pad))
    g = eighths(y.shape)
    exact(upfirdn2d_bwd_cuda(g, k, up, pad, shape), upfirdn2d_backward(g, k, up, pad, shape))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(set(fused_bias_act_calls()))
                         + [(16, 512), (4096, 512), (3, 5, 7, 3)], ids=str)
def test_fused_bias_act_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    b = torch.randn(shape[1], generator=g, device=card)
    before = fused_bias_act_cuda.launches
    got = fused_leaky_relu(x, b)
    assert fused_bias_act_cuda.launches == before + 1
    check(got, fused_leaky_relu_plain(x, b))
    torch.cuda.synchronize()


def test_kernels_refuse_what_they_do_not_take(card):
    x = torch.randn(1, 2, 8, 8, device=card)
    k = make_kernel((1, 3, 3, 1), gain=4)
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x, k, 3, (1, 1))
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x, make_kernel((1, 2, 3, 3, 2, 1)), 1, (1, 1))
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x.transpose(2, 3), k, 1, (1, 1))
    with pytest.raises(TypeError):
        fused_bias_act_cuda(x.half(), torch.zeros(2, device=card))
    with pytest.raises(ValueError):
        upfirdn2d_bwd_cuda(x, k, 3, (1, 1), (1, 2, 4, 4))
    with pytest.raises(TypeError):
        fused_bias_act_bwd_cuda(x, x.bfloat16())
    with pytest.raises(ValueError):
        fused_bias_act_bwd_cuda(x, x[:, :1].contiguous())
    # K1's backward is the kernel too: the gradient of the skip upsample
    y = upfirdn2d_fir(x.requires_grad_(), k, 2, (2, 1))
    g = torch.randn_like(y)
    before = upfirdn2d_bwd_cuda.down2_launches
    (dx,) = torch.autograd.grad(y, x, g)
    assert upfirdn2d_bwd_cuda.down2_launches == before + 1
    check(dx, upfirdn2d_backward(g, k, 2, (2, 1), x.shape))


K3_SHAPES = sorted(set(fused_conv_block_calls(16)) | set(fused_conv_block_calls(1)),
                   key=lambda s: (s[0], s[2]))


def _k3_args(card, dtype, seed=2):
    g = torch.Generator(device=card).manual_seed(seed)
    cs = ((256, 128), (128, 64), (64, 64))
    inv = [1 + 0.1 * torch.randn(ci, generator=g, device=card) for ci, _ in cs]
    off = [0.1 * torch.randn(ci, generator=g, device=card) for ci, _ in cs]
    w = [torch.randn(co, ci, 3, 3, generator=g, device=card) * (2.0 / (9 * co)) ** 0.5
         for ci, co in cs]
    return k3.make_k3_args(inv, off, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_fused_conv_block_kernel_matches_plain(card, shape, dtype):
    args = _k3_args(card, dtype)
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(3),
                    device=card).to(dtype)
    before = k3.fused_conv_block_cuda.launches
    got = k3.fused_conv_block(x, args)
    assert k3.fused_conv_block_cuda.launches == before + 1
    check(got, k3.fused_conv_block_plain(x, args), f32_scaled=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 256, 5, 7), (1, 256, 9, 33), (3, 256, 1, 1)], ids=str)
def test_fused_conv_block_kernel_partial_tiles(card, shape, dtype):
    """Sizes that leave the 128-pixel tiles partly empty and tiles that
    span images, with the halo at their edges and the K loop split."""
    args = _k3_args(card, dtype, seed=4)
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(5),
                    device=card).to(dtype)
    check(k3.fused_conv_block_cuda(x, args), k3.fused_conv_block_plain(x, args),
          f32_scaled=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 256, 4, 4), (16, 256, 16, 16), (1, 256, 64, 64),
                                   (16, 256, 64, 64)], ids=str)
def test_fused_conv_block_runs_are_bit_equal(card, shape, dtype):
    """The split K loop's partials are summed in a fixed order (no atomics),
    so two runs give the same bits."""
    args = _k3_args(card, dtype, seed=6)
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(7),
                    device=card).to(dtype)
    assert torch.equal(k3.fused_conv_block_cuda(x, args), k3.fused_conv_block_cuda(x, args))


def test_fused_conv_block_refuses_grad(card):
    """A CUDA input or weight that needs a gradient no longer raises: the
    kernel runs forward (one launch) and its backward recomputes the plain
    version (one K3-bwd call), giving autograd's gradients of the plain
    version for x and for a weight alone; under no-grad no backward is
    recorded."""
    args = _k3_args(card, torch.float32)
    x = torch.randn(2, 256, 8, 8, device=card)
    g = torch.randn(2, 256, 8, 8, device=card)
    w0 = args.w[0].clone().requires_grad_()
    for xin, wargs, leaf in ((x.clone().requires_grad_(), args, None),
                             (x, args._replace(w=(w0,) + args.w[1:]), w0)):
        fwd, bwd = k3.fused_conv_block_cuda.launches, k3.fused_conv_block_bwd.launches
        out = k3.fused_conv_block(xin, wargs)
        wrt = xin if leaf is None else leaf
        (got,) = torch.autograd.grad(out, wrt, g)
        assert k3.fused_conv_block_cuda.launches == fwd + 1
        assert k3.fused_conv_block_bwd.launches == bwd + 1
        (want,) = torch.autograd.grad(k3.fused_conv_block_plain(xin, wargs), wrt, g)
        check(got, want, f32_scaled=True)
    with torch.no_grad():
        assert not k3.fused_conv_block(x.clone().requires_grad_(), args).requires_grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_fused_conv_block_served_args_hit_the_launch_cache(card, monkeypatch, mode, dtype):
    """A FAN ConvBlock whose weights are ``nn.Parameter``s (they need a
    gradient), served under no-grad or inference mode: its args are checked
    on the first call of a shape and kept, so the second call checks
    nothing; a call with grad on (the autograd Function) checks its fresh
    args each time and keeps none of them."""
    from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import (
        ConvBlock, conv_block)
    p = ConvBlock(256, 256).to(card)
    assert all(t.requires_grad for t in p.parameters())
    x = torch.randn(2, 256, 16, 16, generator=torch.Generator(device=card).manual_seed(8),
                    device=card).to(dtype)
    checks = []
    real_check = k3._check
    monkeypatch.setattr(k3, "_check", lambda *a: (checks.append(1), real_check(*a)))
    guard = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with guard:
        first = conv_block(p, x)
        after_first = len(checks)
        second = conv_block(p, x)
    assert after_first == 1 and len(checks) == 1
    assert torch.equal(first, second)
    kept = len(k3._launches)
    for _ in range(2):
        conv_block(p, x.clone().requires_grad_()).sum().backward()
    assert len(checks) == 3 and len(k3._launches) == kept


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_conv_block_backward_matches_plain(card, dtype):
    """Every gradient the autograd Function gives (x, the three folds'
    scales and offsets, the three weights) against autograd through the
    plain version."""
    args = _k3_args(card, dtype)
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(2, 256, 16, 16, generator=g, device=card).to(dtype)
    grad = torch.randn(2, 256, 16, 16, generator=g, device=card).to(dtype)

    def leaves():
        ts = [t.detach().clone().requires_grad_() for t in (x,) + args.inv + args.off + args.w]
        return ts, k3.K3Args(tuple(ts[1:4]), tuple(ts[4:7]), tuple(ts[7:10]), args.wk)

    ts, a = leaves()
    got = torch.autograd.grad(k3.fused_conv_block(ts[0], a), ts, grad)
    ts, a = leaves()
    want = torch.autograd.grad(k3.fused_conv_block_plain(ts[0], a), ts, grad)
    for gt, wt in zip(got, want):
        check(gt, wt, f32_scaled=True)


def test_fused_conv_block_refusals(card):
    args = _k3_args(card, torch.float32)
    x = torch.randn(1, 256, 8, 8, device=card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k3.fused_conv_block_cuda(x.cpu(), args)
    with pytest.raises(ValueError, match="256"):
        k3.fused_conv_block_cuda(torch.randn(1, 128, 8, 8, device=card), args)
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_conv_block_cuda(x.transpose(2, 3), args)
    with pytest.raises(TypeError):
        k3.fused_conv_block_cuda(x.half(), args)
    with pytest.raises(ValueError, match="stage 1"):
        k3.fused_conv_block_cuda(x.bfloat16(), args)


PTI = pti_backward_calls()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("call", PTI.upfirdn2d, ids=lambda c: c.name)
def test_upfirdn2d_bwd_kernel_matches_plain(card, call, dtype):
    """K1 on the gradient of each PTI-step call: up 1, down 1 for the
    blurs, down 2 for the skip upsamples."""
    k = make_kernel((1, 3, 3, 1), gain=4)
    oh, ow = upfirdn2d_output_shape(call.shape[2], call.shape[3], (4, 4), up=call.up,
                                    pad=call.pad)
    g = torch.randn(call.shape[:2] + (oh, ow), generator=torch.Generator(device=card).manual_seed(6),
                    device=card).to(dtype)
    before = (upfirdn2d_bwd_cuda.launches, upfirdn2d_bwd_cuda.down2_launches)
    got = upfirdn2d_bwd_cuda(g, k, call.up, call.pad, call.shape)
    assert (upfirdn2d_bwd_cuda.launches, upfirdn2d_bwd_cuda.down2_launches) == (
        before[0] + 1, before[1] + int(call.up == 2))
    exact(got, upfirdn2d_backward(g, k, call.up, call.pad, call.shape))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(set(PTI.fused_bias_act)), ids=str)
def test_fused_bias_act_bwd_kernel_matches_plain(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(7)
    g = torch.randn(shape, generator=gen, device=card).to(dtype)
    y = fused_leaky_relu_plain(torch.randn(shape, generator=gen, device=card).to(dtype))
    before = fused_bias_act_bwd_cuda.launches
    got = fused_bias_act_bwd_cuda(g, y)
    assert fused_bias_act_bwd_cuda.launches == before + 1
    check(got, fused_leaky_relu_bwd_plain(g, y))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_autograd_matches_plain_autograd(card, dtype):
    """Gradients through the kernels' autograd Functions against autograd
    through the plain versions, on the card."""
    gen = torch.Generator(device=card).manual_seed(8)
    x = torch.randn(2, 8, 17, 17, generator=gen, device=card).to(dtype)
    b = torch.randn(8, generator=gen, device=card)
    k = make_kernel((1, 3, 3, 1), gain=4)

    def run(f_blur, f_up, f_act):
        xx, bb = x.clone().requires_grad_(), b.clone().requires_grad_()
        h = f_act(f_blur(xx), bb)
        out = f_up(h)
        g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(9),
                        device=card).to(dtype)
        return torch.autograd.grad(out, (xx, bb), g)

    launches = (upfirdn2d_bwd_cuda.launches, fused_bias_act_bwd_cuda.launches)
    got = run(lambda t: upfirdn2d_fir(t, k, 1, (1, 1)), lambda t: upfirdn2d_fir(t, k, 2, (2, 1)),
              fused_leaky_relu)
    assert (upfirdn2d_bwd_cuda.launches, fused_bias_act_bwd_cuda.launches) == (
        launches[0] + 2, launches[1] + 1)
    want = run(lambda t: upfirdn2d(t, k, up=1, pad=(1, 1)),
               lambda t: upfirdn2d(t, k, up=2, pad=(2, 1)), fused_leaky_relu_plain)
    for a, w in zip(got, want):
        check(a.to(dtype), w.to(dtype), f32_scaled=True)


def test_pti_step_gradients_match_plain_path(card):
    """One PTI step of the voxceleb generator (256², channel multiplier 1):
    the gradients of the tuned parameters with K1, K2 and their backwards
    on the card against the plain versions on the CPU, same weights."""
    from stylegan_directions_face_reenactment_tpu_torch.pipeline.pti import (
        pti_objective, split_tunable)
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_generator, init_lpips)

    def grads(device):
        g = init_generator(0, 256, 512, 8, 1, device=device)
        g.requires_grad_(False)
        tuned = split_tunable(g)
        for p in tuned:
            p.requires_grad_(True)
        rs = torch.Generator().manual_seed(10)
        code = (0.5 * torch.randn(1, 14, 512, generator=rs)).to(device)
        real = (torch.rand(1, 256, 256, 3, generator=rs) * 2 - 1).to(device)
        trunc = torch.randn(1, 512, generator=rs).to(device)
        total, _, _ = pti_objective(g, code, real, init_lpips(1, device=device), trunc)
        total.backward()
        return float(total.detach()), [p.grad.cpu() for p in tuned]

    before = (upfirdn2d_bwd_cuda.launches, upfirdn2d_bwd_cuda.down2_launches,
              fused_bias_act_bwd_cuda.launches)
    loss, got = grads(card)
    after = (upfirdn2d_bwd_cuda.launches, upfirdn2d_bwd_cuda.down2_launches,
             fused_bias_act_bwd_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (
        len(PTI.upfirdn2d), sum(c.up == 2 for c in PTI.upfirdn2d), len(PTI.fused_bias_act))
    want_loss, want = grads("cpu")
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    noise = [torch.cat([t for t in grads if t.numel() == 1]) for grads in (got, want)]
    torch.testing.assert_close(noise[0], noise[1], rtol=1e-3,
                               atol=1e-2 * float(noise[1].abs().max()))
    for a, w in zip(got, want):
        if w.numel() > 1:
            torch.testing.assert_close(a, w, rtol=1e-3, atol=2e-3 * float(w.abs().max()))
