"""StreamDiffusionDepth: the per-frame stream runtime, in torch.

Port of ``live2diff_tpu/stream/pipeline.py`` for the configuration without
a depth model (the depth latents are zeros; the depth-mapping branch of the
UNet still runs). One streamed frame is:

    encode (TAESD) -> stream-batch UNet over the n denoising steps ->
    LCM consistency step -> decode (TAESD)

Stream-batch semantics (StreamDiffusion): the UNet batch carries the ``n``
denoising steps of ``n`` consecutive frames, the new frame at the noisiest
timestep plus the n-1 buffered latents, so each frame costs one UNet call
and outputs lag inputs by n-1 frames. ``prepare`` runs the warmup program
that encodes 8 frames and fills every step row of the KV caches.

Noise is drawn from the state's ``torch.Generator``; every draw can instead
come from a caller's ``noise`` function (``shape -> tensor``), which is how
the tests replay the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.unet import UNet3DConditionModel
from ..models.vae import TinyAutoencoder
from ..schedule import LCMSchedule
from .state import StreamState
from .state_machine import init_window_state, mask_to_bias, update_window_state

NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass
class StreamConfig:
    height: int = 512
    width: int = 512
    do_add_noise: bool = True
    vae_scale_factor: int = 8
    vae_scaling: float = 1.0  # TAESD consumes and produces scaled SD latents
    cache_dtype: torch.dtype = torch.bfloat16
    # emit frames as uint8 [0, 255] on the device
    output_uint8: bool = False

    @property
    def latent_height(self) -> int:
        return self.height // self.vae_scale_factor

    @property
    def latent_width(self) -> int:
        return self.width // self.vae_scale_factor


class StreamDiffusionDepth:
    """Runs the UNet and TAESD modules as the stream's warmup and frame steps.

    ``dtype`` is the modules' compute dtype; latents, schedule math and the
    stream buffers stay fp32, as in the JAX package.
    """

    def __init__(
        self,
        unet: UNet3DConditionModel,
        vae: TinyAutoencoder,
        schedule: LCMSchedule,
        stream_config: StreamConfig,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.unet, self.vae = unet, vae
        self.schedule, self.cfg = schedule, stream_config
        self.device, self.dtype = torch.device(device), dtype
        self.num_steps = n = schedule.num_steps

        def col(a):  # per-step scalars shaped to broadcast over [n, h, w, c]
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)[:, None, None, None]

        self.c_skip, self.c_out = col(schedule.c_skip), col(schedule.c_out)
        self.alpha, self.beta = col(schedule.alpha_prod_sqrt), col(schedule.beta_prod_sqrt)
        self.sub_timesteps = torch.as_tensor(
            np.asarray(schedule.sub_timesteps, np.int64), device=self.device
        )
        self._prompt_embeds: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, seed: int = 2) -> StreamState:
        cfg, n = self.cfg, self.num_steps
        lh, lw = cfg.latent_height, cfg.latent_width
        ucfg = self.unet.config
        mask, pe_idx, update_idx = init_window_state(
            n, ucfg.window_size, ucfg.sink_size, device=self.device
        )
        buf_shape = (max(n - 1, 0), lh, lw, 4)
        return StreamState(
            generator=torch.Generator(device=self.device).manual_seed(seed),
            attn_mask=mask,
            pe_idx=pe_idx,
            update_idx=update_idx,
            kv_caches=ucfg.init_caches(lh, lw, n, dtype=cfg.cache_dtype, device=self.device),
            x_t_buffer=torch.zeros(buf_shape, device=self.device),
            depth_buffer=torch.zeros(buf_shape, device=self.device),
        )

    def set_prompt(self, prompt_embeds: torch.Tensor) -> None:
        """[L, D] or [1, L, D] text embedding, broadcast to the step batch."""
        if prompt_embeds.dim() == 2:
            prompt_embeds = prompt_embeds[None]
        embeds = torch.as_tensor(prompt_embeds, device=self.device, dtype=self.dtype)
        self._prompt_embeds = embeds.expand(self.num_steps, *embeds.shape[1:]).contiguous()

    def _randn(self, state: StreamState, shape, noise: Optional[NoiseFn]) -> torch.Tensor:
        if noise is not None:
            return noise(tuple(shape)).to(device=self.device, dtype=torch.float32)
        return torch.randn(shape, generator=state.generator, device=self.device)

    # ------------------------------------------------------------------
    # latent codecs
    # ------------------------------------------------------------------

    def _encode_frame_and_depth(self, state, frames_rgb: torch.Tensor, noise):
        """[F, H, W, 3] in [-1, 1] -> (x_t noised at t0, depth latents).
        Without a depth model the depth latents are zeros."""
        latents = self.vae.encode(frames_rgb.to(self.dtype).contiguous()).float()
        latents = latents * self.cfg.vae_scaling
        eps = self._randn(state, latents.shape, noise)
        x_t = self.alpha[0] * latents + self.beta[0] * eps
        return x_t, torch.zeros_like(latents)

    def _decode_latents(self, x0: torch.Tensor) -> torch.Tensor:
        img = self.vae.decode((x0 / self.cfg.vae_scaling).to(self.dtype)).float()
        img = torch.clamp(img, -1.0, 1.0)
        if self.cfg.output_uint8:
            img = torch.round((img + 1.0) * 127.5).to(torch.uint8)
        return img

    # ------------------------------------------------------------------
    # LCM consistency step
    # ------------------------------------------------------------------

    def _scheduler_step_batch(self, model_pred, x_t):
        """Batched LCM x0-prediction: F = (x - beta*eps)/alpha;
        x0 = c_out * F + c_skip * x."""
        f_theta = (x_t - self.beta * model_pred) / self.alpha
        return self.c_out * f_theta + self.c_skip * x_t

    # ------------------------------------------------------------------
    # the two programs
    # ------------------------------------------------------------------

    def _unet_apply(self, x_t, depth, state: StreamState, prompt_embeds):
        out, new_caches = self.unet(
            x_t[:, None].to(self.dtype),
            self.sub_timesteps,
            prompt_embeds,
            depth[:, None].to(self.dtype),
            state.kv_caches,
            "stream",
            mask_to_bias(state.attn_mask),
            state.pe_idx,
            state.update_idx,
        )
        return out[:, 0].float(), new_caches

    @torch.no_grad()
    def _frame_step(self, state: StreamState, frame_rgb: torch.Tensor, prompt_embeds,
                    noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """One streamed frame: encode -> stream-batch UNet -> LCM -> decode."""
        cfg, n = self.cfg, self.num_steps
        if frame_rgb.dtype == torch.uint8:
            frame_rgb = frame_rgb.float() / 127.5 - 1.0
        x_t_new, depth_new = self._encode_frame_and_depth(state, frame_rgb[None], noise)
        if n > 1:
            x_t = torch.cat([x_t_new, state.x_t_buffer], dim=0)
            depth = torch.cat([depth_new, state.depth_buffer], dim=0)
        else:
            x_t, depth = x_t_new, depth_new

        model_pred, new_caches = self._unet_apply(x_t, depth, state, prompt_embeds)
        x0_batch = self._scheduler_step_batch(model_pred, x_t)
        mask, pe_idx, update_idx = update_window_state(
            state.attn_mask, state.pe_idx, state.update_idx, self.unet.config.sink_size
        )

        if n > 1:
            x0_out = x0_batch[-1]
            if cfg.do_add_noise:
                eps = self._randn(state, x0_batch[:-1].shape, noise)
                x_t_buffer = self.alpha[1:] * x0_batch[:-1] + self.beta[1:] * eps
            else:
                x_t_buffer = self.alpha[1:] * x0_batch[:-1]
            depth_buffer = depth[:-1]
        else:
            x0_out = x0_batch[0]
            x_t_buffer, depth_buffer = state.x_t_buffer, state.depth_buffer

        out_rgb = self._decode_latents(x0_out[None])[0]
        new_state = dataclasses.replace(
            state, attn_mask=mask, pe_idx=pe_idx, update_idx=update_idx,
            kv_caches=new_caches, x_t_buffer=x_t_buffer, depth_buffer=depth_buffer,
            frame_idx=state.frame_idx + 1,
        )
        return new_state, out_rgb

    @torch.no_grad()
    def _warmup_denoise(self, state: StreamState, warmup_rgb: torch.Tensor, prompt_embeds,
                        noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """Encode the warmup frames and run the denoise loop with
        bidirectional temporal attention, filling every step row's cache."""
        x_t, depth = self._encode_frame_and_depth(state, warmup_rgb, noise)
        caches = state.kv_caches
        sample = x_t[None].to(self.dtype)  # [1, F, h, w, 4]
        depth5 = depth[None].to(self.dtype)
        prompt1 = prompt_embeds[:1]
        x0 = None
        for idx in range(self.num_steps):
            out, caches = self.unet(
                sample, self.sub_timesteps[idx:idx + 1], prompt1, depth5, caches,
                "warmup", None, None, None, idx,
            )
            model_pred = out[0].float()  # [F, h, w, 4]
            x_cur = sample[0].float()
            f_theta = (x_cur - self.beta[idx] * model_pred) / self.alpha[idx]
            x0 = self.c_out[idx] * f_theta + self.c_skip[idx] * x_cur
            if idx < self.num_steps - 1:
                eps = self._randn(state, x0.shape, noise)
                sample = (self.alpha[idx + 1] * x0 + self.beta[idx + 1] * eps)[None].to(self.dtype)
        out_rgb = self._decode_latents(x0)
        return dataclasses.replace(state, kv_caches=tuple(caches)), out_rgb

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def prepare(self, warmup_frames, prompt_embeds: torch.Tensor, seed: int = 2,
                noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """warmup_frames: [8, H, W, 3] float in [-1, 1]. Returns the filled
        state and the warmup frames' outputs."""
        self.set_prompt(prompt_embeds)
        state = self.init_state(seed)
        frames = torch.as_tensor(warmup_frames, device=self.device)
        return self._warmup_denoise(state, frames, self._prompt_embeds, noise)

    def warm_frame_step(self, frame_dtype=torch.float32) -> float:
        """Run one dummy frame step on a throwaway state (the first step
        pays for library autotuning and the kernels' first loads); returns
        wall seconds."""
        if self._prompt_embeds is None:
            raise RuntimeError("set_prompt()/prepare() before warm_frame_step()")
        t0 = time.perf_counter()
        dummy = torch.zeros((self.cfg.height, self.cfg.width, 3), dtype=frame_dtype,
                            device=self.device)
        self._frame_step(self.init_state(seed=0), dummy, self._prompt_embeds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def __call__(self, state: StreamState, frame, noise: Optional[NoiseFn] = None
                 ) -> Tuple[StreamState, torch.Tensor]:
        """frame: [H, W, 3] float in [-1, 1] or uint8. Returns (state, the
        output frame on the device)."""
        if self._prompt_embeds is None:
            raise RuntimeError("call prepare() first")
        frame = torch.as_tensor(frame, device=self.device)
        return self._frame_step(state, frame, self._prompt_embeds, noise)
