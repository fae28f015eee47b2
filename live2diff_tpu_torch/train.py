"""Motion-module trainer: clips -> latents -> train step, with checkpoints.

Port of ``live2diff_tpu/train.py``:

  ClipDataset [B,F,H,W,3] --AutoencoderKL encode (frozen)-->  latents
  caption     --CLIP (a checkpoint's), else a fixed draw-->   text embeds
  parallel/train.py:make_train_step (tp over ranks, DDP over dp) --torch.save--> save/resume

It runs on the card unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``), in fp32: on the card the attention and its gradient go
through the fp32 flash kernels (``ops/flash_train.py``).

Usage:
  python -m live2diff_tpu_torch.train --tiny --device cpu      # synthetic smoke
  python -m live2diff_tpu_torch.train --data DIR --caption "..." --steps 10000

Without ``--sd-checkpoint`` every weight is drawn from the seed in the
manner of the JAX package's initialisers: kernels N(0, 1/fan_in), norm
scales 1, biases 0, and the motion modules' ``proj_out`` and the depth
branch's ``conv_out`` zero (a fresh motion module is a no-op).
``--sd-checkpoint`` names an LDM checkpoint (``.ckpt`` / ``.safetensors``):
its UNet and VAE weights are ingested by name (the motion modules, which
such a file does not hold, stay drawn), and its CLIP weights encode the
caption, with the tokenizer (``vocab.json`` and ``merges.txt``) from the
checkpoint's folder or its ``tokenizer/``.

For several ranks, start the process group first (one process a card,
``torch.distributed.init_process_group`` with its address, world size and
rank). The ranks form the JAX trainer's default mesh
(``live2diff_tpu/train.py:99``, ``parallel/mesh.py:make_mesh``): as much
tensor parallelism as divides the world up to 8 (each tp rank holds a slab
of the UNet's attention, feed-forward and resnet weights,
``parallel/tp.py``), the rest data parallelism (each dp rank trains on its
share of every batch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from .builder import resolve_device
from .convert.checkpoint import build_module, channels_last_convs_, load_into, vae_state_dict
from .convert.ldm import convert_ldm_checkpoint
from .convert.state_dict import load_state_dict_file
from .models.text_encoder import CLIPTextConfig, CLIPTextModelWithFinalNorm
from .models.unet import UNet3DConditionModel, UNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .parallel.mesh import batch_shard, make_mesh
from .parallel.tp import shard_params
from .parallel.train import TrainState, make_optimizer, make_train_step
from .utils.tokenizer import CLIPTokenizer

__all__ = ["TrainerConfig", "Trainer", "synthetic_clips", "main"]

TINY_UNET = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                 cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2)
TINY_VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
# weights a fresh module holds at zero
ZERO_INIT = ("temporal_transformer.proj_out.weight", "flow_conv_in.conv_out.weight")


@dataclasses.dataclass
class TrainerConfig:
    data: Optional[str] = None          # video root; None => synthetic
    caption: str = "a video clip"
    steps: int = 30
    batch: int = 2                      # clips a step, over all ranks
    clip_len: int = 4
    height: int = 64
    width: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.01
    ckpt_dir: Optional[str] = None
    save_every: int = 100
    log_every: int = 10
    resume: bool = False
    tiny: bool = False
    seed: int = 0
    use_depth: bool = False
    sd_checkpoint: Optional[str] = None  # an LDM checkpoint file (optional)


def synthetic_clips(cfg: TrainerConfig) -> Iterator[np.ndarray]:
    """One deterministic moving-gradient clip, repeated: the overfit target.

    A single fixed batch means the loss must drop if the step works."""
    f, h, w = cfg.clip_len, cfg.height, cfg.width
    t = np.arange(f, dtype=np.float32)[:, None, None, None]
    y = np.linspace(-1, 1, h, dtype=np.float32)[None, :, None, None]
    x = np.linspace(-1, 1, w, dtype=np.float32)[None, None, :, None]
    clip = np.concatenate(
        [np.sin(3 * x + 0.5 * t) * np.cos(2 * y),
         np.cos(4 * y - 0.3 * t) * 0.5 + 0.2 * x,
         np.sin(2 * (x + y) + t) * 0.7],
        axis=-1,
    ).astype(np.float32)
    batch = np.broadcast_to(clip, (cfg.batch, f, h, w, 3)).copy()
    while True:
        yield batch


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter in place, as the JAX package's initialisers do
    (without their truncation): weights of rank >= 2 N(0, 1/fan_in), norm
    scales 1, biases 0, the ``ZERO_INIT`` weights 0."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(ZERO_INIT) or (p.dim() == 1 and not name.endswith("weight")):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module


def _random_module(make: Callable[[], nn.Module], device: torch.device,
                   generator: torch.Generator) -> nn.Module:
    with torch.device("meta"):
        module = make()
    return channels_last_convs_(init_weights_(module.to_empty(device=device), generator))


def clip_config(clip_sd: Dict[str, torch.Tensor]) -> CLIPTextConfig:
    """SD-1.5's CLIP text config at the width of a checkpoint's CLIP weights
    (64-wide heads, a 4x MLP)."""
    for key in ("text_model.final_layer_norm.weight",
                "text_model.embeddings.token_embedding.weight"):
        if key in clip_sd:
            width = clip_sd[key].shape[-1]
            return CLIPTextConfig(hidden_size=width, num_heads=max(1, width // 64),
                                  intermediate_size=4 * width)
    return CLIPTextConfig()


class Trainer:
    """Builds the models and the step once; ``fit()`` runs the loop. On the
    card unless ``device`` says otherwise."""

    def __init__(self, cfg: TrainerConfig, device: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh()
        if cfg.batch % self.mesh.dp:
            raise ValueError(f"--batch {cfg.batch} must split over {self.mesh.dp} dp ranks")
        if cfg.tiny:
            ucfg = UNetConfig(**TINY_UNET, cond_mapping=cfg.use_depth)
            vcfg = VAEConfig(**TINY_VAE)
        else:
            ucfg, vcfg = UNetConfig(cond_mapping=cfg.use_depth), VAEConfig()
        # one seed stream for the weights and the caption, one for the steps
        w_seed, step_seed = np.random.SeedSequence(cfg.seed).generate_state(2)
        gen = torch.Generator(device=self.device).manual_seed(int(w_seed))
        self.unet = _random_module(lambda: UNet3DConditionModel(ucfg), self.device, gen)
        self.vae = _random_module(lambda: AutoencoderKL(vcfg), self.device, gen)
        self._text_len = 7 if cfg.tiny else 77
        self.text_embeds = torch.randn((1, self._text_len, ucfg.cross_attention_dim),
                                       generator=gen, device=self.device)
        if cfg.sd_checkpoint:
            clip_sd = self._load_weights(cfg.sd_checkpoint)
            enc = self._encode_caption(cfg.sd_checkpoint, clip_sd, cfg.caption, gen)
            if enc is not None:
                self.text_embeds = enc
        self.vae.eval().requires_grad_(False)
        shard_params(self.unet, self.mesh)  # every rank drew the whole UNet alike

        optimizer = make_optimizer(self.unet, cfg.lr, cfg.weight_decay)
        self.state = TrainState(
            step=0, unet=self.unet, optimizer=optimizer,
            generator=torch.Generator(device=self.device).manual_seed(int(step_seed)))
        self._step_fn = make_train_step(self.unet, optimizer, mesh=self.mesh)
        if cfg.resume and cfg.ckpt_dir:
            self._maybe_resume()

    # -- weights ------------------------------------------------------------

    def _load_weights(self, path: str) -> Dict[str, torch.Tensor]:
        """Ingest an LDM checkpoint's UNet and VAE weights over the random
        draw, by name; returns its CLIP weights in the HF names."""
        unet_sd, vae_sd, clip_sd = convert_ldm_checkpoint(load_state_dict_file(path))
        missing: List[str] = []
        load_into(self.unet, unet_sd, missing)
        load_into(self.vae, vae_state_dict(vae_sd), missing)
        if missing:
            print(f"[train] {len(missing)} params not found in {path}; kept random")
        return {k if k.startswith("text_model.") else f"text_model.{k}": v
                for k, v in clip_sd.items()}

    def _encode_caption(self, path: str, clip_sd: Dict[str, torch.Tensor], caption: str,
                        generator: torch.Generator) -> Optional[torch.Tensor]:
        """The caption through the checkpoint's CLIP weights (those it lacks
        drawn N(0, 0.02^2)): ``[1, 77, D]`` fp32, or None (the fixed draw
        stays) when the checkpoint has no CLIP weights or no tokenizer sits
        beside it. Raises when the CLIP width is not the UNet's
        ``cross_attention_dim``."""
        if not clip_sd:
            print(f"[train] no CLIP weights in {path}; the caption embedding stays random")
            return None
        config = clip_config(clip_sd)
        width = self.unet.config.cross_attention_dim
        if config.hidden_size != width:
            raise ValueError(f"{path}: CLIP width {config.hidden_size} is not the UNet's "
                             f"cross_attention_dim {width}")
        folder = path if os.path.isdir(path) else os.path.dirname(os.path.abspath(path))
        try:
            tokenizer = CLIPTokenizer.from_pretrained(folder)
        except FileNotFoundError:
            print(f"[train] no tokenizer under {folder}; the caption embedding stays random")
            return None
        missing: List[str] = []
        model = build_module(lambda: CLIPTextModelWithFinalNorm(config), self.device,
                             torch.float32, generator, clip_sd, missing)
        ids = torch.from_numpy(tokenizer([caption]).astype(np.int64)).to(self.device)
        with torch.no_grad():
            return model(ids).float()

    # -- checkpoint/resume --------------------------------------------------

    def _maybe_resume(self) -> None:
        from .parallel.checkpoint import latest_step_dir, restore_train_state

        latest = latest_step_dir(self.cfg.ckpt_dir)
        if latest:
            restore_train_state(latest, self.state)
            print(f"[train] resumed from {latest} (step {self.state.step})")

    def save(self) -> Optional[str]:
        """Checkpoint to ``<ckpt_dir>/step_<N>``: the tp ranks of dp rank 0
        gather their slabs and global rank 0 writes one unsharded state (the
        dp ranks hold the same one). Returns the path on rank 0."""
        if not self.cfg.ckpt_dir or self.mesh.dp_rank != 0:
            return None
        from .parallel.checkpoint import save_train_state

        path = os.path.join(self.cfg.ckpt_dir, f"step_{self.state.step}")
        path = save_train_state(path, self.state, write=self.mesh.rank == 0)
        return path if self.mesh.rank == 0 else None

    # -- the loop ------------------------------------------------------------

    def batches(self) -> Iterator[np.ndarray]:
        if self.cfg.data:
            from .parallel.data import ClipDataset

            ds = ClipDataset(self.cfg.data, clip_len=self.cfg.clip_len,
                             stride=self.cfg.clip_len, height=self.cfg.height,
                             width=self.cfg.width)
            return ds.batches(self.cfg.batch, seed=self.cfg.seed)
        return synthetic_clips(self.cfg)

    @torch.no_grad()
    def encode(self, clips: torch.Tensor) -> torch.Tensor:
        """[B, F, H, W, 3] clips -> [B, F, h, w, 4] latents: the frames
        folded into the batch, the VAE's mean latents times its scaling."""
        b, f = clips.shape[:2]
        z = self.vae.encode(clips.reshape(b * f, *clips.shape[2:]))
        z = z * self.vae.config.scaling_factor
        return z.reshape(b, f, *z.shape[1:])

    def make_batch(self, clips: np.ndarray) -> Dict[str, torch.Tensor]:
        """This rank's train batch from a global batch of host clips."""
        local = batch_shard(self.mesh, torch.from_numpy(np.ascontiguousarray(clips)))
        latents = self.encode(local.to(self.device))
        batch = {"latents": latents,
                 "text": self.text_embeds.expand(latents.shape[0], *self.text_embeds.shape[1:])}
        if self.cfg.use_depth:
            batch["depth"] = torch.zeros_like(latents)
        return batch

    def train_step(self, clips: np.ndarray) -> float:
        """One step on a global batch of host clips ``[B, F, H, W, 3]``;
        returns the loss (the mean over the ranks). A non-finite loss
        raises."""
        self.state, loss = self._step_fn(self.state, self.make_batch(clips))
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {self.state.step - 1}")
        return loss

    def fit(self) -> dict:
        cfg = self.cfg
        losses: list = []
        start = self.state.step
        t0 = time.time()
        for i, clips in enumerate(self.batches()):
            if start + i >= cfg.steps:
                break
            loss = self.train_step(clips)
            losses.append(loss)
            step = self.state.step
            if cfg.log_every and step % cfg.log_every == 0:
                rate = (i + 1) / (time.time() - t0)
                print(f"[train] step {step} loss {loss:.5f} ({rate:.2f} it/s)")
            if cfg.ckpt_dir and cfg.save_every and step % cfg.save_every == 0:
                self.save()
        if cfg.ckpt_dir:
            self.save()
        k = max(len(losses) // 5, 1)
        return {
            "steps": len(losses),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "loss_head_mean": float(np.mean(losses[:k])) if losses else None,
            "loss_tail_mean": float(np.mean(losses[-k:])) if losses else None,
            "losses": losses,
        }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--data", default=None, help="video root (omit = synthetic)")
    p.add_argument("--caption", default="a video clip")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--clip-len", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny models and synthetic defaults")
    p.add_argument("--use-depth", action="store_true")
    p.add_argument("--sd-checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    a = p.parse_args(argv)

    defaults = TrainerConfig()
    cfg = TrainerConfig(
        data=a.data, caption=a.caption,
        steps=a.steps if a.steps is not None else (30 if a.tiny else 10000),
        batch=a.batch if a.batch is not None else defaults.batch,
        clip_len=a.clip_len if a.clip_len is not None else defaults.clip_len,
        height=a.height if a.height is not None else (64 if a.tiny else 256),
        width=a.width if a.width is not None else (64 if a.tiny else 256),
        lr=a.lr, ckpt_dir=a.ckpt_dir, save_every=a.save_every,
        log_every=a.log_every, resume=a.resume, tiny=a.tiny,
        use_depth=a.use_depth, sd_checkpoint=a.sd_checkpoint, seed=a.seed,
    )
    trainer = Trainer(cfg, device=a.device)
    stats = trainer.fit()
    print(json.dumps({k: v for k, v in stats.items() if k != "losses"}))
    return stats


if __name__ == "__main__":
    main()
