"""StreamV2VWrapper: the user-facing streaming video-to-video API.

Port of ``live2diff_tpu/wrapper.py``: build from a style config,
``prepare(prompt, warmup_frames)`` once, then ``img2img(frame)`` (or
``wrapper(frame)``) per frame; ``update_prompt`` and ``update_lora_scale``
change the prompt and a fused LoRA's strength mid-stream.

On the card each frame is one replay of the captured step
(``stream/graph.py``), and ``prepare`` captures it, so the first frame
replays too. Both live updates write in place what the graph reads: the
prompt through ``set_prompt``, a LoRA's delta into the parameters
themselves, whose addresses the graph holds.

``engine_dir`` holds primed kernel libraries (``aot.py``): on the card the
constructor loads them from ``<engine_dir>/aot/<key>/`` when it is primed
for this card and toolchain (``aot_hit``), before any kernel launches,
so no ``nvcc`` runs; ``prime_aot()`` writes them. The directory must be as
trusted as the package's sources: loading a library runs its code. The
JAX wrapper also points XLA's persistent compilation cache at
``<engine_dir>/xla_cache``; the port has no counterpart beyond the build
directory (``build/kernels/``), which holds the libraries it builds.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Literal, Optional, Union

import numpy as np
import torch

from .aot import load_engines, save_engines
from .builder import BuiltPipeline, build_pipeline, encode_prompt_for_pipeline
from .convert.lora import lora_delta_state_dict
from .utils.filter import SimilarImageFilter
from .utils.image import postprocess_image, preprocess_image

WARMUP_FRAMES = 8


def _add_deltas_(module: torch.nn.Module, deltas: Dict[str, torch.Tensor]) -> int:
    """params[k] += deltas[k], in fp32 and rounded once to the parameter's
    dtype, written into the parameter's own memory. Returns the count."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for key, d in deltas.items():
            p = params[key]
            p.copy_(p.float() + d.to(p.device))
    return len(deltas)


class StreamV2VWrapper:
    def __init__(
        self,
        config_path: Union[str, Dict],
        num_inference_steps: Optional[int] = None,
        t_index_list: Optional[List[int]] = None,
        strength: Optional[float] = None,
        lora_dict: Optional[Dict[str, float]] = None,
        output_type: Literal["pil", "pt", "np", "latent"] = "pil",
        height: int = 512,
        width: int = 512,
        use_tiny_vae: bool = True,
        use_depth: bool = True,
        use_text_encoder: bool = True,
        do_add_noise: bool = True,
        enable_similar_image_filter: bool = False,
        similar_image_filter_threshold: float = 0.98,
        similar_image_filter_max_skip_frame: int = 10,
        seed: int = 42,
        engine_dir: str = "engines",
        dtype="bfloat16",
        unet_overrides: Optional[Dict] = None,
        kv_cache_dtype: Optional[str] = None,
        output_uint8: Optional[bool] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """The JAX wrapper's arguments, plus ``device``: the card unless
        ``"cpu"`` is asked for. On the card the kernel libraries are loaded
        from ``engine_dir`` where it is primed for this card and toolchain
        (``aot_hit``), and built at first use otherwise."""
        self.height, self.width = height, width
        self.output_type = output_type
        self.seed = seed
        self.built: BuiltPipeline = build_pipeline(
            config_path,
            height=height,
            width=width,
            num_inference_steps=num_inference_steps,
            t_index_list=t_index_list,
            strength=strength,
            use_tiny_vae=use_tiny_vae,
            use_depth=use_depth,
            use_text_encoder=use_text_encoder,
            dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
            do_add_noise=do_add_noise,
            lora_dict=lora_dict,
            unet_overrides=unet_overrides,
            kv_cache_dtype=kv_cache_dtype,
            # uint8 frames leave the device for the uint8 output types: the
            # host path's rounding, a quarter of the bytes
            output_uint8=(output_type in ("np", "pil") if output_uint8 is None
                          else output_uint8),
            device=device,
        )
        if self.built.missing_artifacts:
            print(f"[live2diff-tpu-torch] {len(self.built.missing_artifacts)} missing weight "
                  f"artifacts (running randomly initialised): "
                  f"{list(self.built.missing_artifacts)[:4]}...")
        self.stream = self.built.stream
        self.device = self.stream.device
        self.batch_size = self.built.schedule.num_steps
        self.engine_dir = engine_dir
        # a miss (or the CPU) builds the kernels at first use
        self.aot_hit = load_engines(self.stream, engine_dir)
        self.similar_filter = (
            SimilarImageFilter(similar_image_filter_threshold,
                               similar_image_filter_max_skip_frame)
            if enable_similar_image_filter else None)
        self._state = None
        self._prev_output = None
        self.inference_time_ema = 0.0
        self.inference_time_list: List[float] = []
        self.first_step_warm_s = 0.0
        self.capture_s = 0.0

    def prime_aot(self) -> bool:
        """Write this pipeline's kernel libraries (built now where they
        are not yet) into ``engine_dir``, so that later processes start
        without ``nvcc``. Returns False on the CPU, which has none."""
        return save_engines(self.stream, self.engine_dir) is not None

    # ------------------------------------------------------------------

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """The prompt inside the style's template -> ``[1, 77, 768]``: the
        template's ``{}`` takes the prompt, or the prompt follows it."""
        template = self.built.prompt_template
        text = template.replace("{}", prompt) if "{}" in template else f"{template} {prompt}"
        return encode_prompt_for_pipeline(self.built, text)

    def prepare(self, prompt: str, warmup_frames, warm_step: bool = True):
        """warmup_frames: 8 frames ([8, H, W, 3] uint8 or float, or a list
        of images). Returns their outputs as ``output_type``.

        ``warm_step`` runs the step once eagerly on a throwaway state (the
        kernels' builds and loads, library plan choices; its seconds in
        ``first_step_warm_s``) and, on the card, captures the step of the
        new state for float32 frames (``capture_s``), so that the first
        ``img2img`` replays at steady-state latency."""
        frames = np.stack([preprocess_image(f, self.height, self.width) for f in warmup_frames])
        embeds = self.encode_prompt(prompt)
        self._state, out = self.stream.prepare(torch.from_numpy(frames), embeds,
                                               seed=self.seed)
        self.first_step_warm_s = self.capture_s = 0.0
        if warm_step:
            self.first_step_warm_s = self.stream.warm_frame_step(torch.float32)
            self.capture_s = self.stream.capture_step(self._state, torch.float32)
        return postprocess_image(out, self.output_type)

    def update_lora_scale(self, lora: str, scale: float) -> int:
        """Change a fused LoRA's strength mid-stream, without a rebuild or
        a new capture: ``w += (scale - fused) * unit * up @ down`` for each
        of its modules, from the factors the build kept (``lora_runtime``),
        computed in fp32 on the host and written into the live parameters
        in place. ``lora`` matches by full path, basename or unique
        substring. Returns the number of parameters updated. A change to the
        text encoder shows from the next ``update_prompt``."""
        matches = [k for k in self.built.lora_runtime
                   if k == lora or os.path.basename(k) == lora or lora in k]
        if len(matches) != 1:
            raise KeyError(f"lora {lora!r} matches {matches or 'nothing'} among "
                           f"{[os.path.basename(k) for k in self.built.lora_runtime]}")
        entry = self.built.lora_runtime[matches[0]]
        delta_alpha = float(scale) - float(entry["fused_alpha"])
        if delta_alpha == 0.0:
            return 0
        unet_d, text_d = lora_delta_state_dict(entry["records"], delta_alpha)
        n = _add_deltas_(self.built.unet, unet_d)
        if text_d and self.built.text_encoder is not None:
            n += _add_deltas_(self.built.text_encoder, text_d)
        entry["fused_alpha"] = float(scale)
        return n

    def update_prompt(self, prompt: str) -> None:
        """A new prompt, through the style template as in ``prepare``."""
        self.stream.set_prompt(self.encode_prompt(prompt))

    def img2img(self, image):
        """One frame in, one frame out (``output_type``); outputs lag inputs
        by ``batch_size - 1`` frames."""
        if self._state is None:
            raise RuntimeError("call prepare() with 8 warmup frames first")
        t0 = time.perf_counter()
        frame = preprocess_image(image, self.height, self.width)
        if self.similar_filter is not None and self.similar_filter(frame) is None \
                and self._prev_output is not None:
            time.sleep(self.inference_time_ema)
            return self._prev_output
        self._state, out = self.stream(self._state, torch.from_numpy(frame))
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        self.inference_time_ema = (dt if not self.inference_time_list
                                   else 0.9 * self.inference_time_ema + 0.1 * dt)
        self.inference_time_list.append(dt)
        self._prev_output = postprocess_image(out, self.output_type)
        return self._prev_output

    __call__ = img2img

    def timing_summary(self) -> Dict[str, float]:
        """EMA, mean and std of the frame seconds (the first frame left
        out) and the fps of the mean."""
        times = np.asarray(self.inference_time_list[1:] or [0.0])
        return {
            "ema_s": self.inference_time_ema,
            "mean_s": float(times.mean()),
            "std_s": float(times.std()),
            "fps": float(1.0 / times.mean()) if times.mean() > 0 else 0.0,
        }
