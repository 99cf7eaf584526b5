"""The StyleGAN3-T cell (``sg3t_ffhq1024.crops``) on the CPU at a tiny
size: its files resolve, a whole run passes the check, the planted faults
are refused, its reference imports nothing of the port or of JAX, and its
readers and work functions read what a run leaves."""

import copy
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from harness import cell, common

CELL = "sg3t_ffhq1024.crops"
SECONDS = 6.0


def run_for(seed: int = 2**31 + 11, fault=None, control: bool = False):
    """The cell at 32² with 6 synthesis layers (8 W+ rows, 4 shifted),
    a narrow generator, FAN with one hourglass module, chunks of 2."""
    w = common.cell(CELL)
    cfg = copy.deepcopy(common.config(w["config"]))
    cfg["generator"].update(resolution=32, channel_base=1024, channel_max=32, num_layers=6)
    cfg["fan"]["num_modules"] = 1
    cfg["directions"]["num_layers_shift"] = 4
    tr = dict(common.traffic(w["traffic"]))
    tr.update(chunk=2, warm_chunks=1, pool_frames=4, check_chunks=2)
    return cell.Run(w, cfg, tr, seed, torch.device("cpu"), control=control, fault=fault)


def result(run, seconds: float = SECONDS):
    return cell.run_cell(run, seconds, False, 0.0)


def test_cell_files_resolve():
    w = common.cell(CELL)
    assert w["chips"] == 1
    cfg = common.config(w["config"])
    assert cfg["generator"]["arch"] == "stylegan3-t" and cfg["reduced"] == []
    tr = common.traffic(w["traffic"])
    assert cell.entry(tr).__name__ == "harness.entries.reenact_crops_sg3"
    assert set(common.load_json(os.path.join(common.BENCH_DIR, "limits", f"{CELL}.json"))) \
        == {"image_units", "image_max_rel", "shift_rel", "shift_frames_off"}
    names = {m["name"] for m in cell.per_layer_names(CELL)}
    assert {"k4_roofline", "filtered_lrelu_ms", "sg3_hires_ms.span", "deca_ms.span",
            "synthesis_ms.span", "idle_pct.in_program", "mfu.reenact"} <= names
    for m in names:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics", f"{m}.py")), m


def test_published_layer_table_in_the_configuration():
    from reference.model.models import stylegan3 as ref_sg3
    from harness import nets_sg3
    cfg = common.config(common.cell(CELL)["config"])
    with torch.device("meta"):
        g = nets_sg3.construct("reference.model", cfg)
    assert g.synthesis.layer_names == cfg["generator"]["layers"].split()
    assert g.n_latent == cfg["generator"]["n_latent"] == 16
    assert isinstance(g, ref_sg3.Generator)


def test_sound_run_is_correct():
    res = result(run_for())
    assert res["correct"], res["numbers"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _altered(fn):
    def wrapped(*args):
        out = list(fn(*args))
        out[0] = out[0].clone()
        out[0][0] = -out[0][0]
        return tuple(out)
    return wrapped


def _half(fn):
    def wrapped(*args):
        *src, frames = args
        out = fn(*src, frames[: frames.shape[0] // 2])
        return tuple(torch.cat([o, o]) for o in out)
    return wrapped


@pytest.mark.parametrize("fault", [_altered, _half], ids=["altered", "half"])
def test_reenact_fault_is_refused(fault):
    res = result(run_for(fault=fault))
    assert not res["correct"], res["numbers"]


def test_deca_rolled_is_refused(monkeypatch):
    mod = importlib.import_module(f"{common.PORT}.pipeline.reenactment")
    deca = mod.calculate_shapemodel

    def rolled(*args, **kwargs):
        params, angles = deca(*args, **kwargs)
        return {k: v.roll(1, dims=0) for k, v in params.items()}, angles.roll(1, dims=0)

    monkeypatch.setattr(mod, "calculate_shapemodel", rolled)
    res = result(run_for())
    assert not res["correct"], res["numbers"]
    assert {n["name"] for n in res["numbers"] if not n["ok"]} & {"shift_rel", "shift_frames_off"}


def test_k4_tile_fault_is_refused(monkeypatch):
    """One 4x4 tile of the last filtered leaky ReLU before ToRGB read one
    row off, as a wrong tile origin would: a few pixels move, and the
    frame's worst pixel refuses it."""
    sg3 = importlib.import_module(f"{common.PORT}.models.stylegan3")
    k4 = sg3.filtered_lrelu
    last = run_for().cfg["generator"]["num_layers"] - 1

    def faulty(x, *args, **kwargs):
        y = k4(x, *args, **kwargs)
        faulty.calls += 1
        if faulty.calls % (last + 2) == last + 1:      # the layer before ToRGB
            c = y.shape[-1] // 2
            y = y.clone()
            y[..., c:c + 4, c:c + 4] = y[..., c + 1:c + 5, c:c + 4]
        return y

    faulty.calls = 0
    monkeypatch.setattr(sg3, "filtered_lrelu", faulty)
    res = result(run_for())
    assert not res["correct"], res["numbers"]
    assert "image_max_rel" in {n["name"] for n in res["numbers"] if not n["ok"]}


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, 'port_bench'); "
            "import reference.reenact_sg3, reference.model.models.stylegan3, "
            "reference.model.ops.filtered_lrelu; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{common.FORBIDDEN + (common.PORT,)!r}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_flops_leave_out_the_fir_taps():
    """The reference's FLOPs of a synthesis count the modulated convolutions
    and affines, not the zero-stuffed FIR convolutions."""
    from reference import reenact_sg3
    from harness import nets_sg3
    run = run_for()
    g = nets_sg3.reference_g(run.cfg, run.seed, torch.device("cpu"))
    lat = torch.randn(1, g.n_latent, 512)
    with torch.no_grad():
        flops = reenact_sg3.count_flops(lambda: reenact_sg3.images(g, lat))
    convs = 0
    for name in g.synthesis.layer_names:
        m = getattr(g.synthesis, name)
        hw = int(m.in_size[0]) + m.conv_kernel - 1
        convs += 2 * m.out_channels * m.in_channels * m.conv_kernel ** 2 * hw * hw
    affines = sum(2 * m.weight.numel() for name, m in g.synthesis.named_modules()
                  if name.endswith("affine"))
    c, s = g.synthesis.input.channels, int(g.synthesis.input.size[0])
    fourier = 2 * c * c * s * s + 2 * 2 * c * s * s     # the 1x1 mix and the grid's phases
    assert convs + affines + fourier <= flops <= convs + affines + fourier + 1e3, (
        flops, convs, affines, fourier)


def test_k4_work_functions():
    from harness.work_k4 import k4_bytes, k4_flops, k4_out_hw
    # L10 of the published table: 534² in, up 4 (24 taps), down 2 (12), pads (-6, -9)
    pad = (-6, -9, -6, -9)
    assert k4_out_hw(534, 534, 24, 12, 4, 2, pad) == (1044, 1044)
    f = k4_flops((16, 81, 534, 534), 24, 12, 4, 2, pad)
    h1 = 534 * 4 - 15 - 23
    per_plane = (534 * h1 + h1 * h1) * 6 + (h1 * 1044 + 1044 * 1044) * 12
    assert f == 2.0 * 16 * 81 * per_plane
    assert k4_bytes((16, 81, 534, 534), 24, 12, 4, 2, pad) == 16 * 81 * (534**2 + 1044**2) * 4 \
        + 4 * 81


class _Ev:
    """A profiler event as the readers see it."""

    def __init__(self, rate=None, shapes=None, concrete=None):
        self.kwinputs = {} if rate is None else {"rate": rate}
        self.input_shapes, self.concrete_inputs = shapes, concrete


class _Trace:
    def __init__(self, under):
        self._under = under

    def under_op(self, op):
        return self._under.get(op, [])


def _read(name, under, requests=2):
    from types import SimpleNamespace
    run = SimpleNamespace(readings={"trace": _Trace(under), "requests": requests})
    return cell.read_metric(name, run)


def test_sg3_readers_on_a_stub_trace():
    from harness.work_k4 import k4_bytes, k4_flops, k4_roofline_pct
    layers = [(_Ev(1024), 0.010), (_Ev(512), 0.5), (_Ev(1024), 0.002), (_Ev(), 0.3)]
    assert _read("sg3_hires_ms.span", {"sg3.layer": layers}) == pytest.approx(6.0)
    assert _read("sg3_hires_ms.span", {"sg3.layer": layers[1:2]}) is None
    args = (None, None, [0.5] * 12, [0.25] * 12, 2, 2, [9, 8, 9, 8])
    calls = [(_Ev(shapes=[[2, 4, 40, 40], [4]], concrete=args), 0.004),
             (_Ev(shapes=[[2, 4, 40, 40], [4]], concrete=args), 0.002)]
    assert _read("filtered_lrelu_ms", {"sdfr::filtered_lrelu": calls}) == pytest.approx(3.0)
    want = k4_roofline_pct(2 * k4_flops((2, 4, 40, 40), 12, 12, 2, 2, (9, 8, 9, 8)),
                           2 * k4_bytes((2, 4, 40, 40), 12, 12, 2, 2, (9, 8, 9, 8)), 0.006)
    assert _read("k4_roofline", {"sdfr::filtered_lrelu": calls}) == pytest.approx(want)
    for name in ("filtered_lrelu_ms", "k4_roofline"):
        assert _read(name, {}) is None


@pytest.mark.cuda
def test_sg3_layer_spans_tile_the_synthesis(card):
    """One traced chunk of the cell at its published size: the ``sg3.layer``
    spans hold the device time of ``reenact.synthesis`` within 1 %, and
    every layer of the table has its span."""
    w = common.cell(CELL)
    tr = dict(common.traffic(w["traffic"]), trace_chunks=1)
    run = cell.Run(w, common.config(w["config"]), tr, 2**31 + 4243, card)
    ent = cell.entry(tr)
    ent.setup(run)
    ent.traced(run)
    trace = run.readings["trace"]
    layers = trace.under_op("sg3.layer")
    synthesis = sum(t for _, t in trace.under_op("reenact.synthesis"))
    in_layers = sum(t for _, t in layers)
    rates = sorted({ev.kwinputs.get("rate") for ev, _ in layers})
    ent.release(run)
    print(f"synthesis {1e3 * synthesis:.3f} ms, layers {1e3 * in_layers:.3f} ms, "
          f"{len(layers)} layer calls, rates {rates}")
    assert len(layers) == 16 and rates == [16, 32, 64, 128, 256, 512, 1024]
    assert abs(in_layers - synthesis) <= 0.01 * synthesis


@pytest.mark.cuda
def test_control_is_refused_and_program_correct_on_the_card(card):
    """The cell's control (the program's bf16 path) is refused on every
    seed; the program itself is correct. (``test_bench_control_card.py``
    times each cell it knows by name, and knows the two older cells only.)"""
    w = common.cell(CELL)
    for seed, control in ((2**31 + 101, True), (2**31 + 102, True), (2**31 + 101, False)):
        run = cell.Run(w, common.config(w["config"]), common.traffic(w["traffic"]), seed, card,
                       control=control)
        res = cell.run_cell(run, 3.0, False, 0.0)
        torch.cuda.empty_cache()
        assert res["correct"] != control, (seed, control, res["numbers"])
