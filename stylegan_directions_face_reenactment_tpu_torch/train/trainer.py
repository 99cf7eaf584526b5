"""Training orchestration on the host: the loops, logging, evaluation and
checkpoints (the reference's ``libs/trainer.py``; the JAX package's
``train/trainer.py``).

It runs the synthetic, real, real_synthetic and paired methods, logs the
losses every ``steps_per_log`` steps (``logs/train_log.jsonl``, and wandb
where it can be imported), evaluates every ``steps_per_ev_log`` steps, saves
A every ``steps_per_save`` steps, and resamples the paired dataset's pairs
every epoch (``trainer.py:398-404``). The steps (``train/steps.py``) do the
device work; this class moves host data and keeps the books.

In a world of several ranks (``parallel/mesh.py::distributed_init``; one
card a rank) every rank runs the same loop on the same data: it keeps its
rows of each batch (``_local``) and the steps average A's gradient over the
world, so every rank holds the same A. Logs, checkpoints, the evaluation's
files, wandb and the GIF come from rank 0 only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.arguments import TrainingArguments
from ..data.datasets import (CustomDataset, CustomDatasetPaired,
                             CustomDatasetPairedValidation, CustomDatasetTestsetReal,
                             CustomDatasetTestsetSynthetic, Loader)
from ..geometry.directions import DirectionsSpec, initialize_directions, make_shift_vector
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..parallel.mesh import average_over_world, rank_rows, replicate, world_info
from ..pipeline.synthesis import generate_image
from ..weights import init_direction_matrix, save_a_matrix
from .checkpoints import start_from_checkpoint
from .eval import extract_evaluation_metrics
from .steps import (FrozenModels, batch_halves, make_accum_step, make_optimizer,
                    make_paired_step, make_real_step, make_shape_program, make_synthetic_step)


class Trainer:
    """Trains the direction matrix A on the models' device, over the world
    of ranks when there is one (the batch must divide it)."""

    def __init__(self, args: TrainingArguments, models: FrozenModels,
                 spec: Optional[DirectionsSpec] = None,
                 log_fn: Callable[[str], None] = print):
        self.args = args
        self.spec = spec or initialize_directions(args.dataset_type, args.learned_directions,
                                                  args.shift_scale)
        self.rank, self.world = world_info()
        if args.batch_size % self.world:
            raise ValueError(f"batch_size {args.batch_size} must divide the mesh "
                             f"({self.world} devices) for data-parallel training")
        self.models = replicate(models)
        self.device = models.device
        self.log_fn = log_fn if self.rank == 0 else (lambda s: None)
        self.output_path = args.experiment_path
        self.models_dir = os.path.join(self.output_path, "models")
        self.images_dir = os.path.join(self.output_path, "images")
        self.logs_dir = os.path.join(self.output_path, "logs")
        if self.rank == 0:
            for d in (self.models_dir, self.images_dir, self.logs_dir):
                os.makedirs(d, exist_ok=True)
            with open(os.path.join(self.output_path, "arguments.json"), "w") as f:
                json.dump(dict(vars(args)), f, indent=2, default=str)
        self.metrics_log: list = []

    # ------------------------------------------------------------------
    def _start(self, seed: int):
        """(first step, A, its optimizer, the steps' generator): A resumed
        from ``resume_training_model`` or drawn from ``seed``."""
        args = self.args
        start_step, a = start_from_checkpoint(args.resume_training_model, self.device)
        if a is not None:
            self.log_fn(f"Resume training from step {start_step}")
        else:
            a = init_direction_matrix(seed, 512, args.learned_directions, w_plus=args.w_plus,
                                      num_layers=args.num_layers_shift, device=self.device)
        replicate(a)
        # every rank draws the same from the same seed and keeps its rows
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        return start_step, a, make_optimizer(a, args), gen

    def _make_step(self, builder, optimizer, **kw):
        """The method's step (``make_accum_step`` splits it into
        ``grad_accum`` microbatches and checks their sizes)."""
        return make_accum_step(builder, self.models, self.spec, self.args, optimizer, **kw)

    def _batch(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _local(self, batch: Dict[str, Any], halves: bool = False,
               micro: bool = True) -> Dict[str, Any]:
        """This rank's rows of a host batch (its arrays and per-row lists):
        its block of each microbatch of the step (``grad_accum``; with
        ``halves``, of each half of each, ``steps.batch_halves``), so that
        the step's microbatch i on this rank is its block of the one-card
        microbatch i; the whole batch on every rank where the rows do not
        divide the world (an evaluation's small remainders)."""
        if self.world == 1:
            return batch
        n = len(next(iter(batch.values())))
        groups = (max(1, self.args.grad_accum or 1) if micro else 1) * (2 if halves else 1)
        try:
            rows = rank_rows(n, self.rank, self.world, groups)
        except ValueError:
            return batch
        return {k: v[rows] if isinstance(v, np.ndarray) else [v[i] for i in rows]
                for k, v in batch.items()}

    def _log(self, step: int, loss_dict: Dict[str, torch.Tensor], mean_loss: float,
             epoch: Optional[int] = None):
        if step % self.args.steps_per_log or self.rank:
            return
        vals = {k: float(v) for k, v in loss_dict.items()}
        head = f"[epoch {epoch:04d}, step {step}]" if epoch is not None else f"[step {step}]"
        body = " | ".join(f"{k}: {v:.2f}" for k, v in vals.items())
        self.log_fn(f"{head} | {body} | Mean Loss {mean_loss:.2f}")
        # the scalar stream (the reference's wandb.log, `trainer.py:195-199`)
        rec = {"step": step, **vals}
        if epoch is not None:
            rec["epoch"] = epoch
        with open(os.path.join(self.logs_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._wandb_log(rec)

    def _wandb_log(self, payload):
        if self.args.use_wandb:
            try:
                import wandb
            except ImportError:
                return   # no wandb here: the files on disk stand in
            wandb.log(payload)

    def _after_step(self, a: DirectionMatrix, step: int):
        args = self.args
        if step % args.steps_per_save == 0 and step > 0 and self.rank == 0:
            save_a_matrix(self.models_dir, a, step, args.learned_directions,
                          args.shift_scale, args.w_plus, args.num_layers_shift)
        # every steps_per_ev_log steps, step 0 included (`utils_train.py:506-510`)
        if args.evaluation and step % args.steps_per_ev_log == 0:
            try:
                self.evaluate(a, step=step)
            except FileNotFoundError as e:
                self.log_fn(f"[eval step {step}] skipped: {e}")

    def _record(self, losses: list, loss_dict, step: int, a, epoch=None):
        losses.append(float(loss_dict["loss"]))
        self._log(step, loss_dict, float(np.mean(losses)), epoch)
        if step % 500 == 0 and step > 0:
            losses.clear()
        self._after_step(a, step)

    # ------------------------------------------------------------------
    def evaluate(self, a: DirectionMatrix, step: int = 0, num_samples: Optional[int] = None,
                 save_figure: bool = True) -> Dict[str, float]:
        """CSIM, pose error and expression error over the method's test set,
        with a [source | target | reenacted] grid (``utils_train.py:735-883``).
        In a world of several ranks the batches are sharded: each rank
        measures its rows, and each batch's three means are averaged over
        the world (one all-reduce a batch; a remainder that does not divide
        the world runs whole on every rank), so every rank returns one
        card's metrics. The grid shows rank 0's first rows; rank 0 writes
        the files."""
        from ..utils.image_utils import generate_grid_image, save_u8
        args, models, spec = self.args, self.models, self.spec
        num_samples = num_samples or args.validation_samples
        method = args.training_method
        if method == "paired":
            ds = CustomDatasetPairedValidation(args.test_dataset_path, num_samples=num_samples,
                                               image_size=args.image_resolution)
        elif method in ("real", "real_synthetic"):
            ds = CustomDatasetTestsetReal(args.test_dataset_path, num_samples=num_samples)
        else:
            ds = CustomDatasetTestsetSynthetic(num_samples=num_samples)
        input_is_latent = method != "synthetic"
        loader = Loader(ds, min(args.test_batch_size, len(ds)), shuffle=False, drop_last=True)
        shapemodel = make_shape_program(models, args)

        def synth(code, shift=None, is_latent=input_is_latent):
            return generate_image(models.generator, code, truncation=args.truncation,
                                  truncation_latent=models.truncation_latent,
                                  shift_code=shift, input_is_latent=is_latent,
                                  num_layers_shift=args.num_layers_shift, w_plus=args.w_plus)

        csims, poses, exps, fig = [], [], [], None
        with torch.no_grad():
            for batch in loader:
                batch = self._local(batch, micro=False)
                if method == "paired":
                    # real frames of one video; metrics against the real target
                    # (evaluate_model_reenactment_video)
                    source_w = self._batch(batch["source_latent_code"])
                    src = self._batch(batch["source_img"])
                    tgt = self._batch(batch["target_img"])
                else:
                    source_w = self._batch(batch["source_w"])
                    src = synth(source_w)
                    tgt = synth(self._batch(batch["target_w"]), is_latent=False)
                p_src, ang_src = shapemodel(src)
                p_tgt, ang_tgt = shapemodel(tgt)
                sv = make_shift_vector(spec, p_src, p_tgt, ang_src, ang_tgt)
                ren = synth(source_w, direction_matrix_forward(a, sv))
                p_ren, ang_ren = shapemodel(ren)
                csim, pe, ee = average_over_world(list(extract_evaluation_metrics(
                    spec, models.id_backbone, p_ren, p_tgt, ang_ren, ang_tgt, ren, src)))
                csims.append(float(csim))
                poses.append(float(pe))
                exps.append(float(ee))
                if save_figure and fig is None:
                    n = min(args.num_pairs_log, src.shape[0])
                    fig = generate_grid_image(src[:n], tgt[:n], ren[:n])
        metrics = {"csim": float(np.mean(csims)) if csims else float("nan"),
                   "pose_error": float(np.mean(poses)) if poses else float("nan"),
                   "expression_error": float(np.mean(exps)) if exps else float("nan")}
        self.metrics_log.append({"step": step, **metrics})
        if self.rank:
            return metrics
        if fig is not None:
            save_u8(fig, os.path.join(self.images_dir, f"{step:04d}_reenactment.png"))
        gif_frames = self._gif(a, step) if args.gif else None
        with open(os.path.join(self.logs_dir, "eval_metrics.json"), "w") as f:
            json.dump(self.metrics_log, f, indent=2)
        self._wandb_eval(step, metrics, fig, gif_frames)
        self.log_fn(f"[eval step {step}] CSIM {metrics['csim']:.4f} | "
                    f"pose {metrics['pose_error']:.3f}° | exp {metrics['expression_error']:.4f}")
        return metrics

    def _gif(self, a: DirectionMatrix, step: int):
        """The directions' interpolation GIF (``utils_train.py:648-693``)."""
        from ..models.stylegan2 import mapping
        from ..utils.visualization import make_interpolation_chart, save_gif
        args, g = self.args, self.models.generator
        z = torch.randn((1, 512), generator=torch.Generator().manual_seed(0)).to(self.device)
        with torch.no_grad():
            lat = mapping(g, z)[:, None].repeat(1, g.n_latent, 1)
            frames = make_interpolation_chart(
                g, a, lat, truncation=args.truncation,
                truncation_latent=self.models.truncation_latent,
                num_layers_shift=args.num_layers_shift,
                directions=list(range(min(4, args.learned_directions))),
                shift_scale=args.shift_scale, steps=2)
        save_gif(frames, os.path.join(self.images_dir, f"{step:04d}_directions.gif"))
        return frames

    def _wandb_eval(self, step, metrics, fig, gif_frames):
        """The evaluation's scalars, grid and GIF frames to wandb
        (``utils_train.py:790-794,865-869``)."""
        if not self.args.use_wandb:
            return
        try:
            import wandb
        except ImportError:
            return
        payload = {f"eval/{k}": v for k, v in metrics.items()}
        payload["step"] = step
        if self.args.log_images_wandb:
            if fig is not None:
                payload["eval/reenactment"] = wandb.Image(fig)
            if gif_frames:
                payload["eval/interpolation"] = [wandb.Image(f) for f in gif_frames]
        wandb.log(payload)

    # ------------------------------------------------------------------
    def train(self, seed: int = 0, n_steps: Optional[int] = None) -> DirectionMatrix:
        """The synthetic method (``trainer.py:135-199``)."""
        start_step, a, opt, gen = self._start(seed)
        step_fn = self._make_step(make_synthetic_step, opt)
        losses: list = []
        for step in range(start_step, n_steps if n_steps is not None else self.args.n_steps):
            self._record(losses, step_fn(a, gen), step, a)
        return a

    def train_real(self, seed: int = 0, n_epochs: Optional[int] = None) -> DirectionMatrix:
        """The real and real_synthetic methods (``trainer.py:201-310``)."""
        args = self.args
        if args.train_dataset_path is None:
            raise ValueError("train_dataset_path required for method 'real'")
        start_step, a, opt, gen = self._start(seed)
        synthetic_half = args.training_method == "real_synthetic"
        use_cache = bool(args.cache_gt_shape)
        step_fn = self._make_step(make_real_step, opt, synthetic_half=synthetic_half,
                                  cached_shape=use_cache)
        shape_fn = make_shape_program(self.models, args) if use_cache else None
        cache: Dict[str, Any] = {}
        dataset = CustomDataset(args.train_dataset_path, image_size=args.image_resolution)
        loader = Loader(dataset, args.batch_size // 2 if synthetic_half else args.batch_size,
                        shuffle=True, drop_last=True)
        n_img, n_ids, n_vid = dataset.get_length()
        self.log_fn(f"Training: {n_img} images {n_ids} ids {n_vid} videos")
        step, losses = start_step, []
        for epoch in range(n_epochs if n_epochs is not None else args.n_steps):
            for batch in loader:
                # real_synthetic's loader gives the real half: its rank block
                batch = self._local(batch, batch_halves(args, "real") and not synthetic_half)
                extra = [self._batch(batch["w"]), self._batch(batch["real_img"])]
                if use_cache:
                    extra += self._gt_shape_for_real_batch(shape_fn, cache, batch)
                self._record(losses, step_fn(a, gen, *extra), step, a, epoch)
                step += 1
        return a

    # ---- the per-frame cache of the dataset frames' DECA coefficients ----
    def _gt_shape_for_batch(self, shape_fn, cache: Dict[str, Any], batch):
        """The batch's source and target coefficients from the per-frame
        cache. Dataset frames are fixed, so their coefficients are training
        invariants (the reference recomputes them every step,
        ``trainer.py:361-365``): on any miss the whole [source; target]
        stack goes through one shape pass; hits cost a host stack."""
        keys = list(batch["source_path"]) + list(batch["target_path"])
        if any(k not in cache for k in keys):
            imgs = np.concatenate([batch["source_img"], batch["target_img"]], axis=0)
            self._gt_shape_fill(shape_fn, cache, keys, imgs)
        p_src, a_src = self._gt_shape_stack(cache, batch["source_path"])
        p_tgt, a_tgt = self._gt_shape_stack(cache, batch["target_path"])
        return p_src, a_src, p_tgt, a_tgt

    def _gt_shape_fill(self, shape_fn, cache, keys, imgs):
        params, angles = shape_fn(self._batch(imgs))
        params = {n: v.cpu().numpy() for n, v in params.items()}
        angles = angles.cpu().numpy()
        for i, k in enumerate(keys):
            cache[k] = ({n: v[i] for n, v in params.items()}, angles[i])

    def _gt_shape_stack(self, cache, keys):
        entries = [cache[k] for k in keys]
        pd = {n: np.stack([e[0][n] for e in entries]) for n in entries[0][0]}
        return ({n: self._batch(v) for n, v in pd.items()},
                self._batch(np.stack([e[1] for e in entries])))

    def _gt_shape_for_real_batch(self, shape_fn, cache, batch):
        """The real methods' one-sided cache: only the real source frames
        are fixed (their targets are drawn in the step)."""
        keys = list(batch["path"])
        if any(k not in cache for k in keys):
            self._gt_shape_fill(shape_fn, cache, keys, batch["real_img"])
        return list(self._gt_shape_stack(cache, keys))

    def train_paired(self, seed: int = 0, n_epochs: Optional[int] = None) -> DirectionMatrix:
        """The paired method, the primary one (``trainer.py:312-405``). With
        ``cache_gt_shape`` (the default) the frames' coefficients are read
        once and kept, and the step runs only the shifted image's shape
        pass."""
        args = self.args
        if args.train_dataset_path is None:
            raise ValueError("train_dataset_path required for method 'paired'")
        start_step, a, opt, gen = self._start(seed)
        use_cache = bool(args.cache_gt_shape)
        step_fn = self._make_step(make_paired_step, opt, cached_shape=use_cache)
        shape_fn = make_shape_program(self.models, args) if use_cache else None
        cache: Dict[str, Any] = {}
        # seeded, so that every rank samples the same pairs
        dataset = CustomDatasetPaired(args.train_dataset_path, max_pairs=2, seed=seed,
                                      image_size=args.image_resolution)
        n_img, n_ids, n_vid = dataset.get_length()
        self.log_fn(f"Training: {n_img} pairs {n_ids} ids {n_vid} videos")
        step, losses = start_step, []
        for epoch in range(n_epochs if n_epochs is not None else args.n_steps):
            loader = Loader(dataset, args.batch_size, shuffle=True, drop_last=True,
                            seed=epoch)
            for batch in loader:
                batch = self._local(batch)
                if use_cache:
                    extra = (self._batch(batch["source_latent_code"]),
                             self._batch(batch["target_latent_code"]),
                             self._batch(batch["target_img"]),
                             *self._gt_shape_for_batch(shape_fn, cache, batch))
                else:
                    extra = (self._batch(batch["source_latent_code"]),
                             self._batch(batch["source_img"]),
                             self._batch(batch["target_latent_code"]),
                             self._batch(batch["target_img"]))
                self._record(losses, step_fn(a, gen, *extra), step, a, epoch)
                step += 1
            dataset.resample()   # new pairs every epoch (`trainer.py:398-404`)
        return a
