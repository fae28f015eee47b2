"""StreamDiffusionDepth: the per-frame stream runtime, in torch.

Port of ``live2diff_tpu/stream/pipeline.py``. One streamed frame is:

    depth (DPT at 384x384) -> one encode (TAESD or the KL codec) of frame
    and depth image -> stream-batch UNet over the n denoising steps -> LCM
    consistency step -> decode

Without a depth model the depth latents are zeros (the depth-mapping
branch of the UNet still runs) and the encode takes the frame alone.

Stream-batch semantics (StreamDiffusion): the UNet batch carries the ``n``
denoising steps of ``n`` consecutive frames, the new frame at the noisiest
timestep plus the n-1 buffered latents, so each frame costs one UNet call
and outputs lag inputs by n-1 frames. ``prepare`` runs the warmup program
that encodes 8 frames and fills every step row of the KV caches.

The step is written for S sessions at once (``_session_step`` over a
stacked state, ``stream/multi.py``): one encode of the S frames (and their
S depth images), one UNet call at batch S * n, one decode, each session's
depth normalised and its noise drawn on its own. A single stream is the
case S = 1, on views of its state.

The step writes the whole state in place (the port's counterpart of the
JAX package's ``donate_argnums=(1,)``): the state it returns holds the very
tensors it was given. On CUDA, ``__call__`` and ``stream_burst`` replay a
CUDA graph of the step (``graph.py``): one launch a frame, the counterpart
of the JAX package's one jitted program a frame.

Noise is drawn from the state's ``torch.Generator``; every draw can instead
come from a caller's ``noise`` function (``shape -> tensor``), which is how
the tests replay the JAX package's draws. A call with ``noise`` runs the
step eagerly, since a Python callback cannot be captured.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.midas import DPTDepthModel, resize_nhwc
from ..models.unet import UNet3DConditionModel
from ..models.vae import AutoencoderKL, TinyAutoencoder
from ..schedule import LCMSchedule
from .graph import StepGraphs
from .state import StreamState, as_sessions, cache_tensors
from .state_machine import init_window_state, mask_to_bias, update_window_state

NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]
# one noise function a session, or None for the sessions' generators
Noises = Optional[Sequence[NoiseFn]]


def _prepend(new: torch.Tensor, buffer: torch.Tensor) -> torch.Tensor:
    """``[S, h, w, c]`` and ``[S, n - 1, h, w, c]`` -> ``[S, n, h, w, c]``, as
    one 4-D cat: CUDA's cat copies every input in one launch up to 4 dims,
    and one launch an input beyond."""
    s, h, w, c = new.shape
    out = torch.cat([new.view(s, 1, h * w, c), buffer.view(s, -1, h * w, c)], dim=1)
    return out.view(s, -1, h, w, c)


@dataclasses.dataclass
class StreamConfig:
    height: int = 512
    width: int = 512
    do_add_noise: bool = True
    vae_scale_factor: int = 8
    # SD-1.5's AutoencoderKL latent scaling, the JAX default; the builder
    # passes 1.0 for TAESD, which consumes and produces scaled latents
    vae_scaling: float = 0.18215
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
    """Runs the UNet, the codec (TAESD or AutoencoderKL) and the optional
    DPT as the stream's warmup and frame steps.

    ``dtype`` is the modules' compute dtype; latents, schedule math, the
    depth normalisation and the stream buffers stay fp32, as in the JAX
    package.
    """

    # the depth model's input size (the reference's MiDaS transform)
    DEPTH_SIZE = 384

    def __init__(
        self,
        unet: UNet3DConditionModel,
        vae: Union[TinyAutoencoder, AutoencoderKL],
        schedule: LCMSchedule,
        stream_config: StreamConfig,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        depth_model: Optional[DPTDepthModel] = None,
    ):
        self.unet, self.vae, self.depth_model = unet, vae, depth_model
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
        self._timesteps: Dict[int, torch.Tensor] = {1: self.sub_timesteps}
        self._prompt_embeds: Optional[torch.Tensor] = None
        self._graphs = StepGraphs()

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

    def set_prompt(self, prompt_embeds) -> None:
        """[L, D] or [1, L, D] text embedding, broadcast to the step batch.

        The first call allocates the prompt buffer; later calls write into
        it, so a captured step reads the new prompt at its next replay (the
        JAX package passes the prompt to its program at every call). A
        prompt of another shape raises."""
        embeds = torch.as_tensor(prompt_embeds, device=self.device, dtype=self.dtype)
        if embeds.dim() == 2:
            embeds = embeds[None]
        shape = (self.num_steps, *embeds.shape[1:])
        if self._prompt_embeds is None:
            self._prompt_embeds = torch.empty(shape, device=self.device, dtype=self.dtype)
        elif self._prompt_embeds.shape != shape:
            raise ValueError(f"set_prompt: prompt of shape {tuple(embeds.shape)}, but this "
                             f"stream's prompt buffer is {tuple(self._prompt_embeds.shape)}")
        self._prompt_embeds.copy_(embeds.expand(shape))

    def _randn(self, generators: Sequence[torch.Generator], shape, noises: Noises
               ) -> torch.Tensor:
        """Each session's draw of ``shape`` from its own generator (or noise
        function), in session order, concatenated on the first axis."""
        if noises is not None:
            draws = [fn(tuple(shape)).to(device=self.device, dtype=torch.float32)
                     for fn in noises]
        else:
            draws = [torch.randn(shape, generator=g, device=self.device) for g in generators]
        return draws[0] if len(draws) == 1 else torch.cat(draws)

    def _step_timesteps(self, sessions: int) -> torch.Tensor:
        """``sub_timesteps`` once a session, [S * n], made once an S."""
        t = self._timesteps.get(sessions)
        if t is None:
            t = self._timesteps[sessions] = self.sub_timesteps.repeat(sessions)
        return t

    # ------------------------------------------------------------------
    # latent codecs
    # ------------------------------------------------------------------

    def _depth_image(self, frames_rgb: torch.Tensor, sessions: int = 1) -> torch.Tensor:
        """[F, H, W, 3] in [-1, 1] -> 3-channel depth image in [-1, 1], fp32.

        Bilinear (no antialiasing) down to 384x384, the DPT, min-max
        normalisation over each session's frames (the F frames are
        ``sessions`` equal groups, session-major: every frame of
        ``prepare``'s warmup together, or one frame a session, as the JAX
        package's ``vmap`` over sessions gives it), replicated to 3
        channels, and resized back to H x W."""
        f, h, w, _ = frames_rgb.shape
        depth_in = resize_nhwc(frames_rgb.float(), self.DEPTH_SIZE, self.DEPTH_SIZE)
        depth = self.depth_model(depth_in.to(self.dtype)).float()  # [F, 384, 384]
        if sessions == 1:
            dmin, dmax = depth.min(), depth.max()
            depth = (depth - dmin) / (dmax - dmin + 1e-6)
        else:
            per = depth.reshape(sessions, -1, *depth.shape[1:])  # [S, F / S, 384, 384]
            dmin = per.amin(dim=(1, 2, 3), keepdim=True)
            dmax = per.amax(dim=(1, 2, 3), keepdim=True)
            depth = ((per - dmin) / (dmax - dmin + 1e-6)).reshape(depth.shape)
        depth3 = depth[..., None].expand(f, self.DEPTH_SIZE, self.DEPTH_SIZE, 3) * 2.0 - 1.0
        return resize_nhwc(depth3, h, w)

    def _encode_frame_and_depth(self, generators, frames_rgb: torch.Tensor, noises: Noises):
        """[F, H, W, 3] in [-1, 1], the frames of ``len(generators)``
        sessions session-major -> (x_t noised at t0, depth latents).

        With a depth model, frames and depth images go through ONE batched
        encode (frames first) and the latents are split after it; without
        one the depth latents are zeros."""
        f, sessions = frames_rgb.shape[0], len(generators)
        if self.depth_model is not None:
            frames_rgb = torch.cat(
                [frames_rgb.float(), self._depth_image(frames_rgb, sessions)], dim=0)
        lat = self.vae.encode(frames_rgb.to(self.dtype).contiguous()).float()
        lat = lat * self.cfg.vae_scaling
        latents = lat[:f]
        depth_lat = lat[f:] if self.depth_model is not None else torch.zeros_like(latents)
        eps = self._randn(generators, (f // sessions, *latents.shape[1:]), noises)
        x_t = self.alpha[0] * latents + self.beta[0] * eps
        return x_t, depth_lat

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

    @torch.no_grad()
    def _session_step(self, states: StreamState, frames_rgb: torch.Tensor, prompt_embeds,
                      noises: Noises = None) -> torch.Tensor:
        """One streamed frame for each of S sessions: encode -> stream-batch
        UNet at batch S * n -> LCM -> decode.

        ``states`` is stacked (``[S, ...]`` tensors, S generators),
        ``frames_rgb`` ``[S, H, W, 3]``, ``prompt_embeds`` ``[S * n, L, D]``
        (session-major) and ``noises`` one noise function a session. Every
        tensor of ``states`` is written in place; each session draws from
        its own generator the numbers, in the order and shapes, that its
        single-session step draws. Returns the ``[S, H, W, 3]`` outputs;
        ``frame_idx`` is the caller's."""
        cfg, n = self.cfg, self.num_steps
        sessions = frames_rgb.shape[0]
        if frames_rgb.dtype == torch.uint8:
            frames_rgb = frames_rgb.float() / 127.5 - 1.0
        x_t_new, depth_new = self._encode_frame_and_depth(states.generator, frames_rgb, noises)
        if n > 1:  # [S, n, h, w, 4]: the new frame first, then the buffered ones
            x_t = _prepend(x_t_new, states.x_t_buffer)
            depth = _prepend(depth_new, states.depth_buffer)
        else:
            x_t, depth = x_t_new[:, None], depth_new[:, None]

        def rows(t):  # [S, n, ...] -> the S * n step rows: a view, never a copy
            return t.view(sessions * n, *t.shape[2:])

        caches = tuple(tuple(rows(t) for t in c) if isinstance(c, tuple) else rows(c)
                       for c in states.kv_caches)
        out, new_caches = self.unet(
            rows(x_t)[:, None].to(self.dtype),
            self._step_timesteps(sessions),
            prompt_embeds,
            rows(depth)[:, None].to(self.dtype),
            caches,
            "stream",
            mask_to_bias(rows(states.attn_mask)),
            rows(states.pe_idx),
            rows(states.update_idx),
        )
        if any(a is not b for a, b in zip(cache_tensors(new_caches), cache_tensors(caches))):
            raise RuntimeError("the UNet returned new KV cache tensors: the stream step "
                               "needs them written in place")
        model_pred = out[:, 0].float().reshape(x_t.shape)
        x0_batch = self._scheduler_step_batch(model_pred, x_t)  # [S, n, h, w, 4]
        window = tuple(rows(t) for t in (states.attn_mask, states.pe_idx, states.update_idx))
        update_window_state(*window, self.unet.config.sink_size, out=window)

        if n > 1:
            # the latent buffers are written in place by the op that makes them
            if cfg.do_add_noise:
                eps = self._randn(states.generator, (n - 1, *x0_batch.shape[2:]), noises)
                torch.add(self.alpha[1:] * x0_batch[:, :-1],
                          self.beta[1:] * eps.reshape(states.x_t_buffer.shape),
                          out=states.x_t_buffer)
            else:
                torch.mul(self.alpha[1:], x0_batch[:, :-1], out=states.x_t_buffer)
            states.depth_buffer.copy_(depth[:, :-1])
        return self._decode_latents(x0_batch[:, -1])

    def _frame_step(self, state: StreamState, frame_rgb: torch.Tensor, prompt_embeds,
                    noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """One streamed frame: ``_session_step`` for one session, on views
        of ``state``. Writes every tensor of ``state`` in place and returns
        a state that holds the same tensors, with ``frame_idx`` advanced."""
        out = self._session_step(as_sessions(state), frame_rgb[None], prompt_embeds,
                                 None if noise is None else (noise,))
        return dataclasses.replace(state, frame_idx=state.frame_idx + 1), out[0]

    @torch.no_grad()
    def _warmup_denoise(self, state: StreamState, warmup_rgb: torch.Tensor, prompt_embeds,
                        noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """Encode the warmup frames and run the denoise loop with
        bidirectional temporal attention, filling every step row's cache.
        uint8 frames are taken as the step takes them (``/ 127.5 - 1``)."""
        if warmup_rgb.dtype == torch.uint8:
            warmup_rgb = warmup_rgb.float() / 127.5 - 1.0
        x_t, depth = self._encode_frame_and_depth(
            (state.generator,), warmup_rgb, None if noise is None else (noise,))
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
                eps = self._randn((state.generator,), x0.shape,
                                  None if noise is None else (noise,))
                sample = (self.alpha[idx + 1] * x0 + self.beta[idx + 1] * eps)[None].to(self.dtype)
        out_rgb = self._decode_latents(x0)
        return dataclasses.replace(state, kv_caches=tuple(caches)), out_rgb

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def prepare(self, warmup_frames, prompt_embeds: torch.Tensor, seed: int = 2,
                noise: Optional[NoiseFn] = None) -> Tuple[StreamState, torch.Tensor]:
        """warmup_frames: [8, H, W, 3] float in [-1, 1] or uint8. Returns the filled
        state and the warmup frames' outputs. Runs eagerly (once a stream);
        on CUDA it first releases the graphs of states the caller dropped."""
        if self.device.type == "cuda":
            self._graphs.release_dropped()
        self.set_prompt(prompt_embeds)
        state = self.init_state(seed)
        frames = torch.as_tensor(warmup_frames, device=self.device)
        return self._warmup_denoise(state, frames, self._prompt_embeds, noise)

    def release_graphs(self) -> None:
        """Release every captured step now, not at the next ``prepare()``:
        for a caller about to drop this pipeline. A later call captures
        again."""
        if self.device.type == "cuda":
            self._graphs.release_all()

    def warm_frame_step(self, frame_dtype=torch.float32) -> float:
        """Run one dummy frame step eagerly on a throwaway state; returns wall
        seconds. The first step pays for the kernels' builds and loads, their
        shared-memory attributes, and cuBLAS and cuDNN plan selection: on
        CUDA it runs on a side stream, as capture asks, and is the warmup
        every capture of a ``frame_dtype`` step relies on (``__call__`` runs
        it before its first capture if the caller has not)."""
        if self._prompt_embeds is None:
            raise RuntimeError("set_prompt()/prepare() before warm_frame_step()")
        t0 = time.perf_counter()
        dummy = torch.zeros((self.cfg.height, self.cfg.width, 3), dtype=frame_dtype,
                            device=self.device)
        if self.device.type != "cuda":
            self._frame_step(self.init_state(seed=0), dummy, self._prompt_embeds)
            return time.perf_counter() - t0
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._frame_step(self.init_state(seed=0), dummy, self._prompt_embeds)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self._graphs.warmed.add(dummy.dtype)
        return time.perf_counter() - t0

    def capture_step(self, state: StreamState, frame_dtype=torch.float32) -> float:
        """Capture the step of ``state`` for ``frame_dtype`` frames now,
        without streaming a frame (a capture records the kernels and runs
        none, so ``state`` is left as it was), so that the first call on it
        replays. Returns the capture's wall seconds: 0.0 on the CPU or where
        the graph exists. Runs the eager warm step first if no call has."""
        if self._prompt_embeds is None:
            raise RuntimeError("call prepare() first")
        if self.device.type != "cuda" or self._graphs.find(state, frame_dtype):
            return 0.0
        return self._graphs.capture(self, state, frame_dtype).capture_s

    def __call__(self, state: StreamState, frame, noise: Optional[NoiseFn] = None
                 ) -> Tuple[StreamState, torch.Tensor]:
        """frame: [H, W, 3] float in [-1, 1] or uint8. Returns (state, the
        output frame on the device).

        On CUDA without ``noise`` this replays the captured step (captured
        at the first call on ``state`` and this frame dtype) and returns a
        fresh copy of the graph's output; a capture that fails raises."""
        if self._prompt_embeds is None:
            raise RuntimeError("call prepare() first")
        if self.device.type == "cuda" and noise is None:
            state, out = self._graphs.step(self, state, torch.as_tensor(frame))
            return state, out.clone()
        frame = torch.as_tensor(frame, device=self.device)
        return self._frame_step(state, frame, self._prompt_embeds, noise)

    def stream_burst(self, state: StreamState, frames, noise: Optional[NoiseFn] = None
                     ) -> Tuple[StreamState, torch.Tensor]:
        """frames: [N, H, W, 3] uint8 or float -> (state, [N, H, W, 3]
        outputs on the device): N steps, the same as N ``__call__``s.

        Port of ``live2diff_tpu/stream/pipeline.py:stream_burst`` (a
        ``lax.scan`` of the step). On CUDA the frames go up in one copy, then
        N replays run, each followed by a device copy of its output into
        slot i, with no host sync between frames. Elsewhere, or with
        ``noise``, it takes N eager steps."""
        if self._prompt_embeds is None:
            raise RuntimeError("call prepare() first")
        frames = torch.as_tensor(frames)
        if frames.dim() != 4 or tuple(frames.shape[1:]) != (self.cfg.height, self.cfg.width, 3):
            raise ValueError(f"stream_burst: expected [N, {self.cfg.height}, {self.cfg.width}, 3]"
                             f" frames, got {tuple(frames.shape)}")
        frames = frames.to(self.device, non_blocking=True)
        out_dtype = torch.uint8 if self.cfg.output_uint8 else torch.float32
        outs = torch.empty(frames.shape, dtype=out_dtype, device=self.device)
        graphs = self.device.type == "cuda" and noise is None
        for i in range(frames.shape[0]):
            if graphs:
                state, out = self._graphs.step(self, state, frames[i])
            else:
                state, out = self._frame_step(state, frames[i], self._prompt_embeds, noise)
            outs[i].copy_(out)
        return state, outs

