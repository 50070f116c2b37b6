"""One typed, frozen configuration for a training run.

Counterpart of signaltrain_tpu/config.py: the CLI parses into a
``RunConfig``, ``train_from_config`` runs it, and its geometry fields are the
ones ``compute_spec`` and the checkpoint keep. The port adds ``device`` (the
card unless ``"cpu"`` is asked for) and ``nproc``, the ranks ``cli.run_train``
spawns (one process a rank, on ``device``'s card and the next ones; 1 trains
in this process). ``n_model`` is the JAX ``"model"`` axis: the ranks that
split the front-end's matrices (``parallel/mesh.py``); ``nproc`` must be
``n_data x n_model``. ``model_kind`` ("mpaec" or "tcn", ``models/kinds.py``)
and ``tcn``, a TCN's sizes (TCN-300-C's by default), pick the model; ``dtype``
None is the model kind's ``default_dtype`` (bfloat16, or float32 for a TCN).
"""

from __future__ import annotations

import dataclasses

import torch

from .models import kinds
from .models.st_model import ModelSpec, compute_spec
from .models.tcn import TCNSpec

DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": torch.float32,
          "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # effect / data
    effect_name: str = "comp_4c"
    datapath: str | None = None
    target_type: str = "stream"  # 'stream' or 'chunk'
    compand: bool = False
    # schedule / optimization
    epochs: int = 1000
    n_data_points: int = 200_000
    batch_size: int = 200
    lr_max: float = 1e-4
    # model and geometry
    model_kind: str = "mpaec"
    tcn: TCNSpec = TCNSpec()
    sr: int = 44100
    scale_factor: float = 1.0
    shrink_factor: float = 4.0
    # numerics / placement
    dtype: str | None = None
    seed: int = 218
    device: str = "cuda"
    # parallelism
    n_model: int = 1
    nproc: int = 1
    # checkpoints / observability
    in_checkpointname: str = "modelcheckpoint.tar"
    out_checkpointname: str = "modelcheckpoint.tar"
    plot_every: int = 10
    cp_every: int = 25
    status_every: int = 10
    make_plots: bool = True

    def model_spec(self, num_knobs: int) -> ModelSpec:
        return compute_spec(scale_factor=self.scale_factor, shrink_factor=self.shrink_factor,
                            num_knobs=num_knobs, sr=self.sr)

    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype] if self.dtype else kinds.spec_class(self.model_kind).default_dtype

    @classmethod
    def from_args(cls, args) -> "RunConfig":
        """argparse namespace (``cli/run_train.py``'s flag surface) -> RunConfig."""
        return cls(
            effect_name=args.effect,
            datapath=args.path,
            target_type=args.target,
            compand=args.compand,
            epochs=args.epochs,
            n_data_points=args.num,
            batch_size=args.batch,
            lr_max=args.lrmax,
            model_kind=getattr(args, "model", "mpaec"),
            tcn=TCNSpec(**{k: getattr(args, k) for k in TCNSpec.SIZES if hasattr(args, k)}),
            sr=args.sr,
            scale_factor=args.scale,
            shrink_factor=args.shrink,
            dtype=args.dtype,
            seed=args.seed,
            device=getattr(args, "device", "cuda"),
            n_model=getattr(args, "nmodel", 1),
            nproc=getattr(args, "nproc", 1),
            in_checkpointname=args.checkpoint,
            out_checkpointname=getattr(args, "out_checkpoint", None) or args.checkpoint,
            cp_every=getattr(args, "cp_every", 25),
        )

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.nproc < 1:
            raise ValueError(f"nproc {self.nproc}: at least one rank")
        if self.n_model < 1 or self.nproc % self.n_model:
            raise ValueError(f"n_model {self.n_model}: nproc {self.nproc} is not n_data x "
                             f"{self.n_model} ranks")


def train_from_config(cfg: RunConfig, effect=None):
    """Build the effect (on ``cfg.device``) and run ``train()`` from one
    RunConfig, in this process (one rank of a data-parallel run when a
    process group is up); returns what ``train()`` returns. ``cfg.nproc`` is
    the launcher's (``cli.run_train``), not read here."""
    from .dsp import effects as fx
    from .training import train as trainlib

    if effect is None:
        effect = fx.make_effect(cfg.effect_name, path=cfg.datapath, sr=cfg.sr, device=cfg.device)
    return trainlib.train(
        effect,
        epochs=cfg.epochs,
        n_data_points=cfg.n_data_points,
        batch_size=cfg.batch_size,
        plot_every=cfg.plot_every,
        cp_every=cfg.cp_every,
        sr=cfg.sr,
        scale_factor=cfg.scale_factor,
        shrink_factor=cfg.shrink_factor,
        lr_max=cfg.lr_max,
        in_checkpointname=cfg.in_checkpointname,
        out_checkpointname=cfg.out_checkpointname,
        seed=cfg.seed,
        status_every=cfg.status_every,
        make_plots=cfg.make_plots,
        device=cfg.device,
        compute_dtype=cfg.compute_dtype(),
        datapath=cfg.datapath,
        target_type=cfg.target_type,
        compand=cfg.compand,
        n_model=cfg.n_model,
        model_kind=cfg.model_kind,
        tcn=cfg.tcn,
    )
