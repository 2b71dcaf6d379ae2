"""Training cells: the synthetic training step as the port's epoch loop
(`train/loop.py::train`) runs it.

Set-up builds the training state with `build_training`, loads the
benchmark's weights into it, and runs the cell's first `check_steps`
steps through the window's own unit: rows from `epoch_batches` over a
seeded corpus, the draws from the loop's generator, `make_train_step`'s
step, `pull_to_host`.  Those steps' losses and task losses, the first
step's per-frame metrics, the first gradient (from Adam's state after one
step), the change, and the proxies and 2D joint targets of the synthetic
batches that the step itself built are what the check holds against the
reference, which follows them from the same weights, rows and draws.
"""

import contextlib
import time

import numpy as np
import torch

from portbench import compare, counters, inputs
from portbench.reference import body as Bm
from portbench.reference import synth
from portbench.reference.train import reference_steps

TRAIN_KEYS = ("lr", "img_wh", "focal_length", "mean_cam_t", "losses_on", "init_loss_weights",
              "metrics_to_track", "params_from", "heatmap_mode", "silhouette_loss_wh", "model",
              "smpl_augment", "cam_augment", "bbox_augment", "proxy_augment")


def train_config(cfg: dict, traffic: dict, seed: int, smpl_dir: str, corpus: str):
    """The port's `TrainConfig` with every key the configuration file states."""
    from straps_tpu_torch.config import TrainConfig, _apply_overrides

    tc = TrainConfig()
    _apply_overrides(tc, {k: cfg[k] for k in TRAIN_KEYS})
    tc.batch_size = int(traffic["batch_size"])
    tc.seed, tc.smpl_dir, tc.train_path, tc.val_path = seed, smpl_dir, corpus, corpus
    return tc


class Driver:
    work_name = "samples"

    def __init__(self, cell, seed: int, device: str, tmp: str):
        from straps_tpu_torch.data.dataset import SyntheticTrainingDataset
        from straps_tpu_torch.train.loop import build_training

        self.setup_log = []
        t = time.perf_counter()
        self.cfg, traffic = cell.config, cell.traffic
        s_body, s_corpus, s_weights, self.loop_seed = inputs.seeds(seed, 4)
        self.arrays = inputs.body_model(s_body)
        smpl_dir = inputs.write_smpl_dir(f"{tmp}/body", self.arrays)
        self.corpus = inputs.write_corpus(f"{tmp}/corpus.npz", int(traffic["corpus_rows"]),
                                          s_corpus)
        self.setup_log.append(("inputs", time.perf_counter() - t))
        t = time.perf_counter()
        self.tc = train_config(self.cfg, traffic, self.loop_seed, smpl_dir, self.corpus)
        self.model, self.assets, self.state, self.train_step, _ = build_training(
            self.tc, device=device)
        self.dev = self.assets.device
        shapes = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        weights = inputs.regressor_weights(shapes, s_weights, self.dev)
        self.model.load_state_dict(weights)
        self.init_state = {k: v.cpu() for k, v in weights.items()}
        del weights
        self.param_names = [k for k, _ in self.model.named_parameters()]
        self.leaf_names = self.param_names + [f"log_var.{t}" for t in self.state.log_vars]
        self.leaf_start = [p.detach().clone()
                           for p in self.state.optimizer.param_groups[0]["params"]]
        self.dataset = SyntheticTrainingDataset(self.corpus, self.tc.params_from)
        self.rng = np.random.RandomState(self.tc.seed)
        self.epoch, self.batches = -1, iter(())
        self.flops_per_unit = self.tc.batch_size * counters.regressor_flops(
            self.tc.model.resnet_layers, self.tc.model.resnet_in_channels, self.tc.img_wh,
            self.tc.model.ief_iters, train=True)
        self.setup_log.append(("program", time.perf_counter() - t))

        # The first steps: warm-up, and the steps the check reads.
        t = time.perf_counter()
        self.losses, self.tasks, self.batches_built = [], [], []
        with self._recording_batches():
            for i in range(int(traffic["check_steps"])):
                self.unit()
                self.losses.append(self.last[0])
                self.tasks.append(self.last[1])
                if i == 0:
                    self.grad1, self.frames1 = self._first_gradient(), self.last[2]
        self.change = self._change()
        self.setup_log.append(("first steps", time.perf_counter() - t))

    @contextlib.contextmanager
    def _recording_batches(self):
        """Keep the proxy silhouettes and cropped 2D joint targets of every
        synthetic batch that `make_train_step`'s step builds meanwhile."""
        from straps_tpu_torch.train import step as S

        build = S.generate_synthetic_batch

        def recording(*args, **kwargs):
            b = build(*args, **kwargs)
            self.batches_built.append(((b.proxy[..., 0] > 0).cpu().numpy(),
                                       b.target_joints2d_coco.cpu().numpy()))
            return b

        S.generate_synthetic_batch = recording
        try:
            yield
        finally:
            S.generate_synthetic_batch = build

    def _rows(self):
        from straps_tpu_torch.data.dataset import epoch_batches

        b = next(self.batches, None)
        if b is None:
            self.epoch += 1
            self.generator = torch.Generator(device=self.dev).manual_seed(
                self.tc.seed * 100003 + self.epoch)
            self.batches = epoch_batches(self.dataset, self.tc.batch_size, self.rng)
            b = next(self.batches)
        return (torch.as_tensor(b["pose"], device=self.dev),
                torch.as_tensor(b["shape"], device=self.dev))

    def unit(self) -> int:
        """One step as the epoch loop runs it."""
        from straps_tpu_torch.train.loop import pull_to_host
        from straps_tpu_torch.train.synthetic import draw_synthetic

        pose, shape = self._rows()
        draws = draw_synthetic(self.generator, pose.shape[0], self.assets.num_verts, self.tc,
                               self.dev)
        self.last = pull_to_host(*self.train_step(self.state, draws, pose, shape))
        return pose.shape[0]

    def traced_unit(self) -> int:
        """The same step as `make_train_step` composes it, each half in a
        range of the benchmark's."""
        from torch.profiler import record_function

        from straps_tpu_torch.train.loop import pull_to_host
        from straps_tpu_torch.train.step import train_on_batch
        from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch

        with record_function("portbench.synth"):
            pose, shape = self._rows()
            draws = draw_synthetic(self.generator, pose.shape[0], self.assets.num_verts,
                                   self.tc, self.dev)
            batch = generate_synthetic_batch(draws, pose, shape, self.assets, self.tc,
                                             augment=True)
        with record_function("portbench.update"):
            pull_to_host(*train_on_batch(self.state, batch, self.assets, self.tc))
        return pose.shape[0]

    @torch.no_grad()
    def _first_gradient(self) -> dict:
        """Each leaf's first gradient norm as Adam holds it after one step:
        its first moment over (1 - beta1)."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        moments = [opt.state.get(p, {}).get("exp_avg") for p in opt.param_groups[0]["params"]]
        return {k: 0.0 if m is None else float(torch.linalg.vector_norm(m) / (1.0 - beta1))
                for k, m in zip(self.leaf_names, moments)}

    @torch.no_grad()
    def _change(self) -> dict:
        params = self.state.optimizer.param_groups[0]["params"]
        return {k: float(torch.linalg.vector_norm(p.detach() - p0))
                for k, p, p0 in zip(self.leaf_names, params, self.leaf_start)}

    def check(self) -> dict:
        """The program's readings, then the program freed and the reference
        run from the same weights, rows and draws."""
        prog = self.program_outputs()
        self.release()
        return compare.train_numbers(prog, self.reference())

    def program_outputs(self) -> dict:
        """The first steps' losses and task losses, the first step's
        per-frame metrics, the first gradient, the change, and the
        proxies and joint targets of the batches the steps built."""
        return {"losses": self.losses, "tasks": self.tasks, "grad1": self.grad1,
                "change": self.change, "frames1": self.frames1,
                "proxy_sil": [sil for sil, _ in self.batches_built],
                "joints2D": [j for _, j in self.batches_built]}

    def release(self):
        for name in ("model", "state", "train_step", "last", "leaf_start",
                     "assets", "generator", "batches"):
            self.__dict__.pop(name, None)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, fp8=False, half=False) -> dict:
        """The reference's first steps from the same weights, rows and draws."""
        dev = self.dev
        body = Bm.body_tensors(self.arrays, dev)
        n_steps, B = len(self.losses), self.tc.batch_size
        with np.load(self.corpus) as c:
            order = np.random.RandomState(self.loop_seed).permutation(len(c["poses"]))
            rows = [(torch.as_tensor(c["poses"][order[i * B:(i + 1) * B]], device=dev),
                     torch.as_tensor(c["shapes"][order[i * B:(i + 1) * B]], device=dev))
                    for i in range(n_steps)]
        gen = torch.Generator(device=dev).manual_seed(self.loop_seed * 100003)
        draws = [synth.draws(gen, B, body["v_template"].shape[0], self.cfg, dev)
                 for _ in range(n_steps)]
        state = {k: v.to(dev) for k, v in self.init_state.items()}
        out = reference_steps(state, self.param_names, body, self.cfg, rows, draws, fp8=fp8,
                              half=half)
        out["proxy_sil"] = [s.cpu().numpy() for s in out["proxy_sil"]]
        out["joints2D"] = [j.cpu().numpy() for j in out["joints2D"]]
        return out
