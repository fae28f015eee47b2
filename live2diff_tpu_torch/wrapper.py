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

Each ``img2img`` is one call of the wrapper in the port's recorder
(``utils/timing.py``): a ``wrapper.img2img`` span with the preprocess, the
filter, the step (upload, replay, output copy), the sync, the fetch and
the postprocess as its children, and, on the card, the captured step's
device stages. ``trace_summary()`` reads them; ``timing_summary()`` is its
summary of the whole call.
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
from .utils.timing import RECORDER, with_routes

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
        flash_variant: str = "dmajor",
    ):
        """The JAX wrapper's arguments, plus ``device``: the card unless
        ``"cpu"`` is asked for, and ``flash_variant`` (``build_pipeline``'s),
        which the JAX wrapper reads from ``LIVE2DIFF_FLASH``. On the card the
        kernel libraries are loaded from ``engine_dir`` where it is primed
        for this card and toolchain (``aot_hit``), and built at first use
        otherwise."""
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
            flash_variant=flash_variant,
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
        self.owner = RECORDER.owner()  # its calls in the recorder
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
        with RECORDER.root("wrapper.img2img", self.owner):
            with RECORDER.span("wrapper.preprocess"):
                frame = preprocess_image(image, self.height, self.width)
            if self.similar_filter is not None:
                with RECORDER.span("wrapper.filter"):
                    skip = self.similar_filter(frame) is None and self._prev_output is not None
                if skip:
                    RECORDER.count("filter_skips", self.owner)
                    time.sleep(self.inference_time_ema)
                    return self._prev_output
            self._state, out = self.stream(self._state, torch.from_numpy(frame))
            if out.is_cuda:
                with RECORDER.span("wrapper.sync"):
                    torch.cuda.synchronize(out.device)
                RECORDER.read_stages(self.owner)
                if self.output_type in ("np", "pil"):
                    with RECORDER.span("wrapper.fetch"):
                        out = out.cpu()
            with RECORDER.span("wrapper.postprocess"):
                self._prev_output = postprocess_image(out, self.output_type)
            return self._prev_output

    __call__ = img2img

    @property
    def inference_time_ema(self) -> float:
        """The EMA of a call's seconds (the recorder's)."""
        return RECORDER.ema_s(self.owner, "wrapper.img2img")

    def trace_summary(self) -> dict:
        """The recorder's read-out of this wrapper's calls in its rings
        (the last 4,096 or more): per span (``wrapper.*``, ``stream.*``) and
        per device stage (``device.*``, on the card) the count and the
        median, p95, mean, std (the first call left out) and EMA in ms; and
        the counters: ``calls``, ``filter_skips``, ``stage_reads_missed``,
        and the process's ``captures`` and ``kernel_loads`` with their
        seconds, ``norm_routes`` (``ops/norm.py:norm_route_counts``),
        ``codec_routes`` (``models/vae.py:codec_route_counts``) and
        ``conv_weight_relayouts`` (``models/resnet.py:count_weight_relayout``)."""
        return with_routes(RECORDER.summary(self.owner))

    def timing_summary(self) -> Dict[str, float]:
        """EMA, mean and std of a call's seconds (the first call left out)
        and the fps of the mean, from the recorder."""
        call = self.trace_summary()["spans"].get("wrapper.img2img")
        if call is None:
            return {"ema_s": 0.0, "mean_s": 0.0, "std_s": 0.0, "fps": 0.0}
        mean_s = call["mean_ms"] / 1e3
        return {"ema_s": call["ema_ms"] / 1e3, "mean_s": mean_s, "std_s": call["std_ms"] / 1e3,
                "fps": 1.0 / mean_s if mean_s > 0 else 0.0}
