"""Motion-module training: the diffusion loss and the train step.

Port of ``live2diff_tpu/parallel/train.py:31-130``: epsilon-prediction MSE
on video clips, with the temporal attention in ``clip`` mode (bidirectional
over the clip), as AnimateDiff trains its motion modules. Only the motion
modules train; the SD-1.5 weights stay frozen.

The JAX step is one jitted program over a (dp, tp) mesh. Here it is eager
PyTorch: the forward, the backward (the attention's through the fp32 flash
kernels on the card, ``ops/flash_train.py``, at H/tp heads a rank) and
``torch.optim.AdamW`` over this rank's motion parameters, with
``DistributedDataParallel`` averaging the gradients over the dp group
(``parallel/mesh.py``); a UNet cut by ``parallel/tp.shard_params`` meets
its tp peers in the forward and backward. The frozen parameters get
``requires_grad_(False)``: no gradient is computed for them and AdamW
never sees them, the same result as ``optax.set_to_zero``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..schedule import make_betas
from .mesh import Mesh, average, batch_shard, make_mesh, wrap_model
from .tp import sync_replicated_grads


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances: the step count, the UNet (its
    motion parameters train), the optimizer over them, and the generator of
    the step's t and noise (the JAX state's PRNG key). The step updates the
    UNet, the optimizer and the generator in place."""

    step: int
    unet: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def is_motion_param(name: str) -> bool:
    """Whether a parameter trains: its name passes through a motion module."""
    return "motion_modules" in name


def make_optimizer(unet: nn.Module, lr: float = 1e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over the motion-module parameters; every other parameter of
    ``unet`` is frozen (``requires_grad_(False)``)."""
    train = []
    for name, p in unet.named_parameters():
        p.requires_grad_(is_motion_param(name))
        if p.requires_grad:
            train.append(p)
    if not train:
        raise ValueError("the UNet has no motion-module parameters to train")
    return torch.optim.AdamW(train, lr=lr, weight_decay=weight_decay)


def alphas_cumprod(num_train_timesteps: int = 1000,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """The training schedule's cumulative products of (1 - beta), fp32."""
    betas = torch.tensor(make_betas(num_train_timesteps), dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def diffusion_loss(
    unet: nn.Module,
    batch: Dict[str, torch.Tensor],
    alphas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    num_train_timesteps: int = 1000,
) -> torch.Tensor:
    """Epsilon-prediction MSE (fp32) of ``unet`` on this rank's clips.

    batch: ``latents`` [B, F, h, w, 4], ``text`` [B, L, D], optional
    ``depth`` [B, F, h, w, 4]; B is this dp rank's share of the global
    batch. ``alphas``: ``alphas_cumprod`` on the latents' device.

    The draws, from ``generator`` (on the latents' device), in this order:
    ``t = randint(0, num_train_timesteps, (B * dp,))``, then ``noise =
    randn(B * dp, F, h, w, 4)``, each over the global batch, of which this
    dp rank keeps its rows, so the ranks together draw what one process
    would; the tp ranks of a dp group, seeded alike, draw the same. A ``t``
    or ``noise`` passed in (this rank's rows) is not drawn:
    the tests replay the JAX package's draws so. Then ``noisy = sqrt(a) x +
    sqrt(1 - a) noise`` with ``a = alphas[t]``, and the UNet runs in
    ``clip`` mode with empty caches."""
    mesh = mesh or Mesh()
    latents = batch["latents"]
    shape = (latents.shape[0] * mesh.dp, *latents.shape[1:])
    if t is None:
        t = batch_shard(mesh, torch.randint(0, num_train_timesteps, shape[:1],
                                            generator=generator, device=latents.device))
    if noise is None:
        noise = batch_shard(mesh, torch.randn(shape, generator=generator,
                                              device=latents.device, dtype=latents.dtype))
    a = alphas[t].reshape(-1, 1, 1, 1, 1)
    noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
    config = getattr(unet, "module", unet).config  # under DDP, the wrapped UNet's
    caches = tuple(latents.new_zeros((0,)) for _ in range(config.num_caches()))
    pred, _ = unet(noisy, t, batch["text"], batch.get("depth"), caches, "clip")
    return F.mse_loss(pred.float(), noise.float())


TrainStep = Callable[..., Tuple[TrainState, torch.Tensor]]


def make_train_step(unet: nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: Optional[Mesh] = None,
                    num_train_timesteps: int = 1000) -> TrainStep:
    """``step(state, batch, t=None, noise=None) -> (state, loss)``: the
    forward, the backward and the AdamW update of ``state``'s UNet (cut by
    ``shard_params`` where the mesh has tp ranks), under
    ``DistributedDataParallel`` over the dp group where it has several
    ranks. ``batch`` holds this dp rank's clips; the loss returned is the
    mean over the dp ranks (the global batch's), a 0-dim device tensor.
    The gradients of the parameters every tp rank holds whole are averaged
    over the tp group before the update (``sync_replicated_grads``), so
    the replicas stay bit-equal."""
    mesh = mesh or make_mesh()
    model = wrap_model(unet, mesh)
    alphas = alphas_cumprod(num_train_timesteps, next(unet.parameters()).device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Tuple[TrainState, torch.Tensor]:
        if state.unet is not unet or state.optimizer is not optimizer:
            raise ValueError("the train state holds another UNet or optimizer than this step's")
        optimizer.zero_grad(set_to_none=True)
        loss = diffusion_loss(model, batch, alphas, state.generator, t, noise, mesh,
                              num_train_timesteps)
        loss.backward()
        sync_replicated_grads(unet)
        optimizer.step()
        state.step += 1
        return state, average(mesh, loss.detach())

    return train_step


def train_step_dryrun(mesh: Optional[Mesh] = None, latent: int = 8, frames: int = 4,
                      device=None) -> float:
    """One tiny training step over the mesh (``live2diff_tpu/parallel/
    train.py:133-182``): the tiny UNet from seed 0 on every rank, cut over
    tp, a batch of ``max(dp, 2)`` clips split over dp, one forward,
    backward and AdamW update. Returns the loss (finite, or it raises). On
    the card unless ``device`` says otherwise."""
    from ..builder import resolve_device
    from ..models.unet import UNet3DConditionModel, UNetConfig
    from ..train import TINY_UNET, init_weights_
    from .tp import shard_params

    mesh = mesh or make_mesh()
    device = resolve_device(device)
    unet = init_weights_(UNet3DConditionModel(UNetConfig(**TINY_UNET)).to(device),
                         torch.Generator(device=device).manual_seed(0))
    shard_params(unet, mesh)
    optimizer = make_optimizer(unet)
    state = TrainState(0, unet, optimizer, torch.Generator(device=device).manual_seed(1))
    b = max(mesh.dp, 2)
    batch = {"latents": torch.full((b, frames, latent, latent, 4), 0.1, device=device),
             "text": torch.zeros((b, 7, unet.config.cross_attention_dim), device=device),
             "depth": torch.zeros((b, frames, latent, latent, 4), device=device)}
    batch = {k: batch_shard(mesh, v) for k, v in batch.items()}
    state, loss = make_train_step(unet, optimizer, mesh)(state, batch)
    loss = float(loss)
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite training loss: {loss}")
    return loss
