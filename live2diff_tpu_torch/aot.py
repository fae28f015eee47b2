"""Warm start from a primed engine directory: the port's counterpart of
``live2diff_tpu/aot.py``.

The JAX package serializes its two compiled programs so that a new process
skips tracing and compiling. A CUDA graph does not outlive its process, so
here the part of start-up that can be saved and shipped is the set of
kernel libraries that ``ops/_build.py`` compiles with ``nvcc`` at first use:
a primed directory lets a new deployment start without ``nvcc`` and without
a writable package directory.

A library's bytes depend on its source and the shared headers, which its
file name already hashes (``_build._lib_path``), and on the compiler flags,
the toolchain and the card; not on the pipeline's shapes or widths. So
``<engine_dir>/aot/<key>/`` is keyed by what is the same for every library
(``engine_key``: the torch and CUDA versions, the card's name and
capability, ``_build.NVCC_FLAGS``), and each library by its own name. It
holds the ``lib<source>-<hash>.so`` of every library the process had
loaded when it primed, and ``manifest.json`` with the key, each library's
file name and the sha256 of its bytes. One directory serves every
configuration on that toolchain and card: a 512x512 and a 768x512
deployment share it.

``save_engines`` runs one step of the stream on a scratch state, so that
every library the step launches is loaded (built where it is not), then
writes every loaded library to a temporary name and moves it into place,
the manifest last. ``load_engines`` checks the manifest's key and every
library's sha256 before it loads any, registers with ``_build.register``
those whose name is the current source's (a library of an edited source is
passed over and that source builds at first use), and validates them by
one step of the stream on a scratch state, fetched to the host. Any failure
returns False with the stream and ``_build``'s libraries as they were, and
deletes nothing: a transient error (out of memory, a busy card) must not
cost a re-prime. There is no fallback around a launch: after a hit, a
launch error raises as it does after a build.

Trust boundary. Loading a ``.so`` runs its code, as unpickling runs the
JAX package's artifacts. The sha256 check catches a torn or stale copy; it
does not stop a writer who can also rewrite the manifest. So
``engine_dir`` must be as trusted as this package's own sources: writable
only by whoever may change the code that runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, Optional

import torch

from .ops import _build, conv

AOT_SCHEMA = "aot2-torch"
MANIFEST = "manifest.json"
TMP_SUFFIX = ".tmp"
# the scratch step's prompt length (CLIP's); no library depends on it
PROMPT_LEN = 77


def _card(device: torch.device) -> tuple:
    return (torch.cuda.get_device_name(device), repr(torch.cuda.get_device_capability(device)))


def engine_key(device: torch.device) -> str:
    """The sha256 prefix naming the primed directory of the libraries built
    for ``device`` (a CUDA device) by this torch, CUDA and compiler flags."""
    parts = (AOT_SCHEMA, torch.__version__, str(torch.version.cuda), *_card(device),
             " ".join(_build.NVCC_FLAGS))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:20]


def engine_path(engine_dir: str, key: str) -> str:
    return os.path.join(engine_dir, "aot", key)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _write_atomic(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, then move it into
    place: a reader sees the old file or the whole new one."""
    tmp = f"{path}.{os.getpid()}{TMP_SUFFIX}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def write_engine_dir(path: str, key: str, libraries: Dict[str, str]) -> None:
    """Copy ``libraries`` ({source: built library path}) into ``path`` and
    write the manifest last. The manifest keeps the earlier entries of
    sources not in ``libraries`` whose files are still there (another
    configuration primed them). Temporary files a torn earlier save left in
    ``path`` go first: they would make ``verified_libraries`` refuse it."""
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(path):
        if name.endswith(TMP_SUFFIX):
            os.unlink(os.path.join(path, name))
    files = {}
    try:
        with open(os.path.join(path, MANIFEST), "rb") as f:
            earlier = json.loads(f.read())
        if earlier.get("schema") == AOT_SCHEMA and earlier.get("key") == key:
            files = {s: e for s, e in earlier["files"].items()
                     if os.path.isfile(os.path.join(path, os.path.basename(e["file"])))}
    except FileNotFoundError:
        pass
    for source, lib in sorted(libraries.items()):
        base = os.path.basename(lib)
        with open(lib, "rb") as src:
            _write_atomic(os.path.join(path, base), lambda f: shutil.copyfileobj(src, f))
        files[source] = {"file": base, "sha256": _sha256(os.path.join(path, base))}
    manifest = {"schema": AOT_SCHEMA, "key": key, "files": files}
    _write_atomic(os.path.join(path, MANIFEST),
                  lambda f: f.write(json.dumps(manifest, indent=1, sort_keys=True).encode()))


class EngineDirRefused(Exception):
    """A primed directory that ``load_engines`` must not load."""


def verified_libraries(path: str, key: str) -> Dict[str, str]:
    """{source: library path} of the primed directory ``path`` for ``key``,
    every library's sha256 checked against the manifest, nothing loaded.
    Raises ``EngineDirRefused`` with the reason: a leftover temporary file
    (a save that did not finish), a manifest of another schema or key, a
    missing library or one whose bytes differ from the manifest's hash."""
    leftovers = sorted(n for n in os.listdir(path) if n.endswith(TMP_SUFFIX))
    if leftovers:
        raise EngineDirRefused(f"{path}: leftover {leftovers}: a save did not finish")
    with open(os.path.join(path, MANIFEST), "rb") as f:
        manifest = json.loads(f.read())
    if manifest.get("schema") != AOT_SCHEMA or manifest.get("key") != key:
        raise EngineDirRefused(f"{path}: manifest of schema {manifest.get('schema')!r}, key "
                               f"{manifest.get('key')!r}; expected {AOT_SCHEMA!r}, {key!r}")
    libs = {}
    for source, entry in manifest["files"].items():
        lib = os.path.join(path, os.path.basename(entry["file"]))
        if not os.path.isfile(lib):
            raise EngineDirRefused(f"{lib}: missing")
        digest = _sha256(lib)
        if digest != entry["sha256"]:
            raise EngineDirRefused(f"{lib}: sha256 {digest}, the manifest says {entry['sha256']}")
        libs[source] = lib
    return libs


def _scratch_step(stream) -> None:
    """One eager step of the stream on a scratch state, fetched to the host:
    it loads every library the step launches, and a launch failure shows at
    the fetch at the latest. The stream's own state, prompt buffer and
    graphs are not touched."""
    cfg = stream.cfg
    frame = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.uint8, device=stream.device)
    prompts = torch.zeros((stream.num_steps, PROMPT_LEN, stream.unet.config.cross_attention_dim),
                          dtype=stream.dtype, device=stream.device)
    _, out = stream._frame_step(stream.init_state(seed=0), frame, prompts)
    torch.cuda.synchronize(stream.device)
    out.cpu()


def save_engines(stream, engine_dir: str = "engines") -> Optional[str]:
    """Run one step of the stream on a scratch state (building the libraries
    it launches where they are not built yet), then copy every library this
    process has loaded, with their manifest, to ``<engine_dir>/aot/<key>/``.
    Returns the key; raises on a failed build, step or write. With a CPU
    stream returns None: the CPU runs no kernel of the port."""
    if stream.device.type != "cuda":
        return None
    _scratch_step(stream)
    key = engine_key(stream.device)
    write_engine_dir(engine_path(engine_dir, key), key, _build.loaded())
    return key


def current_libraries(libs: Dict[str, str]) -> Dict[str, str]:
    """Those of ``libs`` ({source: library path}) built from this package's
    sources: a library's name hashes its source and the shared headers, so
    one built before an edit has another name."""
    return {s: lib for s, lib in libs.items() if s in _build.SOURCES
            and os.path.basename(lib) == os.path.basename(_build._lib_path(s))}


def load_engines(stream, engine_dir: str = "engines") -> bool:
    """Load the kernel libraries primed in ``engine_dir`` for the stream's
    card. Returns True on a hit, validated by one step; sets
    ``stream._aot_load_s``. Returns False and changes nothing on a CPU
    stream or where no manifest is primed for the key; on any other failure
    (none of the libraries is the current sources') prints the reason and
    returns False with ``_build``'s libraries restored. Deletes nothing."""
    if stream.device.type != "cuda":
        return False
    key = engine_key(stream.device)
    path = engine_path(engine_dir, key)
    if not os.path.isfile(os.path.join(path, MANIFEST)):
        return False
    t0 = time.perf_counter()
    with _build._LOCK:
        before = dict(_build._LIBS)
    try:
        libs = verified_libraries(path, key)
        current = current_libraries(libs)
        if not current:
            raise EngineDirRefused(f"{path}: no library of the current sources")
        stale = sorted(set(libs) - set(current))
        if stale:
            print(f"[aot] {path}: {stale} built from other sources; they build at first use")
        for source, lib in current.items():
            _build.register(source, lib)
        _scratch_step(stream)
    except Exception as e:  # a refusal must leave the build-at-first-use path working
        with _build._LOCK:
            _build._LIBS.clear()
            _build._LIBS.update(before)
        # the conv keeps its loaded entry point: drop it with the library
        conv._launcher.cache_clear()
        print(f"[aot] warm start from {path} refused ({e!r}); the kernels build at first use")
        return False
    stream._aot_load_s = time.perf_counter() - t0
    return True
