"""LCM denoising schedule math, precomputed as static tables.

The port's own copy of ``live2diff_tpu/schedule.py`` (plain numpy): the
port imports nothing of the JAX package.

Re-derives everything the reference obtains from ``diffusers==0.25.0``'s
``LCMScheduler`` (reference usage:
upstream Live2Diff live2diff/pipeline_stream_animation_depth.py:54-69,242-301):

* beta schedule -> cumulative alphas (DDIM betas from
  upstream Live2Diff configs/base_config.yaml:30-36),
* LCM inference-timestep selection (``set_timesteps``),
* boundary-condition scalings c_skip / c_out
  (``get_scalings_for_boundary_condition_discrete`` with sigma_data=0.5,
  timestep_scaling=10.0),
* strength -> t_index resolution (``get_timesteps``).

Everything here is plain numpy evaluated once at pipeline build time; the
resulting per-denoise-step vectors become small device tensors of the
stream runtime, so nothing in the hot path recomputes schedule math.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "linear",
) -> np.ndarray:
    """Training beta schedule. ``linear`` is what the reference config uses."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        # cosine schedule (Nichol & Dhariwal)
        steps = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps

        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = 1.0 - alpha_bar(steps[1:]) / alpha_bar(steps[:-1])
        return np.minimum(betas, 0.999)
    raise ValueError(f"unknown beta_schedule: {beta_schedule}")


def lcm_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    original_inference_steps: int = 50,
    strength: float = 1.0,
) -> np.ndarray:
    """LCM inference timesteps, matching diffusers 0.25.0 ``LCMScheduler.set_timesteps``.

    The LCM distillation grid is ``range(1, original_steps+1) * k - 1`` with
    ``k = train_steps // original_steps``; inference picks
    ``num_inference_steps`` approximately-evenly-spaced entries from that grid
    reversed (descending timesteps).
    """
    if num_inference_steps > original_inference_steps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) cannot exceed "
            f"original_inference_steps ({original_inference_steps})"
        )
    k = num_train_timesteps // original_inference_steps
    origin = np.asarray(range(1, int(original_inference_steps * strength) + 1)) * k - 1
    origin = origin[::-1].copy()
    idx = np.floor(np.linspace(0, len(origin), num=num_inference_steps, endpoint=False)).astype(
        np.int64
    )
    return origin[idx]


def boundary_scalings(
    timesteps: np.ndarray, sigma_data: float = 0.5, timestep_scaling: float = 10.0
) -> Tuple[np.ndarray, np.ndarray]:
    """LCM consistency-boundary scalings (c_skip, c_out) per timestep."""
    scaled_t = np.asarray(timesteps, dtype=np.float64) * timestep_scaling
    c_skip = sigma_data**2 / (scaled_t**2 + sigma_data**2)
    c_out = scaled_t / np.sqrt(scaled_t**2 + sigma_data**2)
    return c_skip, c_out


def resolve_t_index_list(
    num_inference_steps: int,
    t_index_list: Optional[Sequence[int]],
    strength: Optional[float],
    num_train_timesteps: int = 1000,
    original_inference_steps: int = 50,
) -> Tuple[List[int], np.ndarray]:
    """Resolve (t_index_list, timesteps) like the reference stream runtime.

    Two modes (upstream Live2Diff live2diff/pipeline_stream_animation_depth.py:56-69,123-131):

    * explicit ``t_index_list``: timesteps = full descending LCM schedule of
      length ``num_inference_steps``; indices select into it.
    * ``strength``: keep only the last ``int(steps*strength)`` timesteps and
      use all of them (t_index = 0..len-1).
    """
    timesteps = lcm_timesteps(
        num_inference_steps,
        num_train_timesteps=num_train_timesteps,
        original_inference_steps=original_inference_steps,
    )
    if strength is not None:
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_timestep, 0)
        timesteps = timesteps[t_start:]
        t_index_list = list(range(len(timesteps)))
        return t_index_list, timesteps
    if t_index_list is None:
        raise ValueError("one of t_index_list / strength must be provided")
    return list(t_index_list), timesteps


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    """All per-denoise-step constants for the stream-batch LCM loop.

    Attributes are float32/int32 numpy arrays of length ``num_steps`` (the
    number of denoising steps, i.e. len(t_index_list)):

    * ``sub_timesteps``: the actual diffusion timestep each batch row runs at.
    * ``c_skip`` / ``c_out``: consistency boundary scalings.
    * ``alpha_prod_sqrt`` / ``beta_prod_sqrt``: sqrt(cumprod alpha), sqrt(1-..)
      at each sub-timestep, used both for noising and for the x0-prediction.
    """

    sub_timesteps: np.ndarray
    c_skip: np.ndarray
    c_out: np.ndarray
    alpha_prod_sqrt: np.ndarray
    beta_prod_sqrt: np.ndarray
    t_index_list: Tuple[int, ...]
    num_inference_steps: int
    strength: Optional[float]

    @property
    def num_steps(self) -> int:
        return len(self.sub_timesteps)

    @classmethod
    def create(
        cls,
        num_inference_steps: int,
        t_index_list: Optional[Sequence[int]] = None,
        strength: Optional[float] = None,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "linear",
        original_inference_steps: int = 50,
        sigma_data: float = 0.5,
        timestep_scaling: float = 10.0,
    ) -> "LCMSchedule":
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)

        t_index_list, timesteps = resolve_t_index_list(
            num_inference_steps,
            t_index_list,
            strength,
            num_train_timesteps=num_train_timesteps,
            original_inference_steps=original_inference_steps,
        )
        sub_timesteps = np.array([timesteps[t] for t in t_index_list], dtype=np.int64)
        c_skip, c_out = boundary_scalings(sub_timesteps, sigma_data, timestep_scaling)
        alpha_prod_sqrt = np.sqrt(alphas_cumprod[sub_timesteps])
        beta_prod_sqrt = np.sqrt(1.0 - alphas_cumprod[sub_timesteps])
        return cls(
            sub_timesteps=sub_timesteps.astype(np.int32),
            c_skip=c_skip.astype(np.float32),
            c_out=c_out.astype(np.float32),
            alpha_prod_sqrt=alpha_prod_sqrt.astype(np.float32),
            beta_prod_sqrt=beta_prod_sqrt.astype(np.float32),
            t_index_list=tuple(t_index_list),
            num_inference_steps=num_inference_steps,
            strength=strength,
        )

    @classmethod
    def from_config(
        cls,
        noise_scheduler_kwargs: dict,
        num_inference_steps: int,
        t_index_list: Optional[Sequence[int]] = None,
        strength: Optional[float] = None,
    ) -> "LCMSchedule":
        """Build from a reference-style ``noise_scheduler_kwargs`` dict."""
        return cls.create(
            num_inference_steps=num_inference_steps,
            t_index_list=t_index_list,
            strength=strength,
            num_train_timesteps=noise_scheduler_kwargs.get("num_train_timesteps", 1000),
            beta_start=noise_scheduler_kwargs.get("beta_start", 0.00085),
            beta_end=noise_scheduler_kwargs.get("beta_end", 0.012),
            beta_schedule=noise_scheduler_kwargs.get("beta_schedule", "linear"),
        )
