"""Persistent knob cache of the empirical tuner (the port's
``repro.tune.cache``).

Winners are stored in a JSON file keyed by ``(shape-bucket, dtype, backend,
device-kind)`` where the shape bucket rounds (M, N, K) up to the next power
of two: the knob landscape is smooth on a log grid (paper §III-C: the NN
predictor works in log-coordinates), so one measurement serves every shape
in its bucket.  The keys are the JAX package's strings: the dtype is its
name (``torch.bfloat16`` -> ``"bfloat16"``), the backend ``"cpu"`` or
``"gpu"`` (the name the JAX package reports for this card), the device kind
``"cpu"`` on the CPU and the normalised ``torch.cuda.get_device_name()``
on the card (``"nvidia_h100_80gb_hbm3"``).

A `Knobs` record holds the JAX package's six fields and, on the card, a
seventh, ``launch``: the launch configuration the card's kernels take in
place of their rule (the wgmma kernels' tile and worker group, the cluster
kernel's K layers, the attention kernels' W, C or S; `tune.tuner`).  It is
written only when set, so an entry of a CPU cache file is byte-identical
to the JAX package's.

The same file persists the calibrated platform constants
(`repro_torch.tune.calibrate.PlatformConstants`) under ``__platform__``
keys, one set per (backend, device kind).  Those are fitted against this
package's kernels, so their key names the package
(``__platform__|repro_torch|<backend>@<device>``) and the JAX package's
constants in a shared file are neither read nor purged here.

Writes are atomic (tmp + rename) and the read-merge-replace critical
section runs under an ``fcntl`` advisory lock (sidecar ``<path>.lock``), so
concurrent tuner processes never lose the slower writer's entries.  A
corrupt file is quarantined to ``<path>.corrupt-<ts>`` (warned once) and
the cache rebuilds from empty.  The package's own version stamp (``META_KEY``,
not the JAX package's ``"__meta__"``, so neither package's stamp purges the
other's file) records the kernel generation the entries were measured
against; on a mismatch they are dropped.  ``__health__|…`` entries
round-trip fallback-ladder quarantine records
(`robust.HealthRegistry.save_to_cache` / ``load_from_cache``).

Counters (`repro_torch.obs`, the JAX module's): ``tune.cache.corrupt`` and
``stale_purge`` by path, ``tune.cache.hit`` / ``miss`` by op and backend at
every `get`, ``tune.cache.platform_purge`` by backend.  The resolvers'
memo (`KnobCache.resolved`) answers a repeated exact call without `get`,
so it counts no hit: JAX counts each lookup once a trace, the port each
`get`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.namespaces import NS_GEMM
from repro_torch.obs import metrics as obs_metrics

try:  # unix-only; the lock degrades to best-effort elsewhere
    import fcntl
except ImportError:  # pragma: no cover - non-posix platform
    fcntl = None

__all__ = [
    "Knobs",
    "KnobCache",
    "shape_bucket",
    "dtype_name",
    "default_cache_path",
    "detect_device_kind",
    "current_kernel_version",
]

META_KEY = "__meta__|repro_torch"
JAX_META_KEY = "__meta__"
HEALTH_PREFIX = "__health__|"
PLATFORM_PREFIX = "__platform__|repro_torch|"
CACHE_ENV = "REPRO_TORCH_SFC_TUNE_CACHE"

# paths already warned about this process (corrupt / stale): warn once
_WARNED_CORRUPT: set = set()
_WARNED_STALE: set = set()
_WARNED_PLATFORM: set = set()


def current_kernel_version() -> int:
    """The kernel generation persisted entries must match:
    `repro_torch.kernels.sfc_gemm.KERNEL_VERSION`."""
    from repro_torch.kernels.sfc_gemm import KERNEL_VERSION

    return int(KERNEL_VERSION)


@dataclasses.dataclass(frozen=True)
class Knobs:
    """One winning SFC-GEMM configuration.

    ``source`` records provenance: "analytical" (the seed, unmeasured),
    "measured" (won an empirical sweep), "predicted" (ranked first by the
    calibrated model with no confirmation), or "cached" (read back from
    disk).  ``time_s`` is the measured or modelled time that made it the
    winner.  ``launch`` (the card only): the launch configuration the
    kernel takes in place of its rule, a dict of small ints, e.g.
    ``{"wide": 1, "group": 2}``; None leaves the rule's."""

    bm: int
    bn: int
    k_layers: int
    k_block_factor: int
    source: str = "analytical"
    time_s: float = 0.0
    launch: Optional[Dict[str, int]] = None

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if self.launch is None:
            del d["launch"]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Knobs":
        launch = d.get("launch")
        return cls(
            bm=int(d["bm"]),
            bn=int(d["bn"]),
            k_layers=int(d["k_layers"]),
            k_block_factor=int(d["k_block_factor"]),
            source=str(d.get("source", "cached")),
            time_s=float(d.get("time_s", 0.0)),
            launch=None if launch is None else {str(k): int(v) for k, v in dict(launch).items()},
        )


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def shape_bucket(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """Round each GEMM extent up to the next power of two."""
    return (_next_pow2(m), _next_pow2(n), _next_pow2(k))


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype: ``torch.bfloat16`` ->
    ``"bfloat16"``; numpy dtypes and names pass through ``np.dtype``."""
    text = str(dtype)
    if text.startswith("torch."):
        return text.split(".", 1)[1]
    return np.dtype(dtype).name


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return str(Path.home() / ".cache" / "repro_torch" / "sfc_knobs.json")


_DEVICE_KIND: Dict[str, str] = {}


def detect_device_kind(backend: str = "cpu") -> str:
    """The device kind of ``backend``'s keys: ``"cpu"`` on the CPU (the JAX
    package's CPU device kind), else ``torch.cuda.get_device_name()``
    lower-cased with spaces as underscores, as the JAX package normalises
    its device kind; "" (the device-less keys) where no card answers, as
    the JAX package's is where detection fails.  Cached per backend for the
    process."""
    if backend not in _DEVICE_KIND:
        import torch

        if backend == "cpu":
            kind = "cpu"
        elif torch.cuda.is_available():
            kind = str(torch.cuda.get_device_name()).strip().replace(" ", "_").lower()
        else:
            kind = ""
        _DEVICE_KIND[backend] = kind
    return _DEVICE_KIND[backend]


class KnobCache:
    """JSON-backed ``(shape-bucket, dtype, backend, device) -> Knobs`` map.

    ``device`` pins the device kind of every key (``""``: the legacy
    device-less keys); None takes each backend's own (`detect_device_kind`).
    ``persist=False`` keeps the entries in memory only (no file is read or
    written): the tuner times a candidate through such a scratch cache.

    ``resolved`` memoises the resolvers' answers (`kernels.ops.
    resolve_knobs`, `core.attention_backend.resolve_attn_knobs`) by their
    exact call, so that a launch with nothing tuned costs one dict lookup;
    every change of the entries empties it."""

    def __init__(self, path: Optional[str] = None, device: Optional[str] = None, *, persist: bool = True):
        self.path = str(path) if path is not None else default_cache_path()
        self._device = device
        self._persist = persist
        self._entries: Optional[Dict[str, Dict]] = None
        self.resolved: Dict[tuple, object] = {}

    def device_of(self, backend: str) -> str:
        return self._device if self._device is not None else detect_device_kind(backend)

    @property
    def device(self) -> str:
        """The device kind of the CPU's keys, unless pinned (the JAX
        package's property; the card's keys take `device_of`)."""
        return self.device_of("cpu")

    @staticmethod
    def key(m: int, n: int, k: int, dtype, backend: str, op: str = NS_GEMM, device: str = "") -> str:
        bm_, bn_, bk_ = shape_bucket(m, n, k)
        base = f"{bm_}x{bn_}x{bk_}|{dtype_name(dtype)}|{backend}"
        if device:
            base = f"{base}@{device}"
        return base if op == NS_GEMM else f"{base}|{op}"

    @staticmethod
    def platform_key(backend: str, device: str = "") -> str:
        """Key of this package's calibrated platform constants for a device."""
        return f"{PLATFORM_PREFIX}{backend}@{device}" if device else f"{PLATFORM_PREFIX}{backend}"

    # ---------------- storage ----------------

    def _quarantine_corrupt(self, err: Exception) -> None:
        """Move an unreadable cache file aside so it never crashes again.
        The warning is deduplicated per path; the counter fires on every
        occurrence."""
        obs_metrics.inc("tune.cache.corrupt", path=self.path)
        dest = f"{self.path}.corrupt-{int(time.time())}"
        try:
            os.replace(self.path, dest)
        except OSError:
            dest = "<unmovable>"
        if self.path not in _WARNED_CORRUPT:
            _WARNED_CORRUPT.add(self.path)
            warnings.warn(
                f"knob cache {self.path} is corrupt ({err}); quarantined to {dest} and rebuilding from empty",
                RuntimeWarning,
                stacklevel=3,
            )

    def _check_version(self, raw: Dict[str, Dict]) -> Dict[str, Dict]:
        """Drop the entries when this package's stamp names another kernel
        generation (the JAX package's stamp and, on a purge, nothing else is
        kept); a missing stamp is a file this package has not written yet."""
        cur = current_kernel_version()
        meta = raw.get(META_KEY)
        stamped = meta.get("kernel_version") if isinstance(meta, dict) else None
        if stamped is not None and int(stamped) != cur and len(raw) > 1:
            obs_metrics.inc("tune.cache.stale_purge", path=self.path)
            if self.path not in _WARNED_STALE:
                _WARNED_STALE.add(self.path)
                warnings.warn(
                    f"knob cache {self.path} was written by kernel version {stamped} (current {cur}); "
                    "dropping stale entries: re-tune to repopulate",
                    RuntimeWarning,
                    stacklevel=3,
                )
            raw = {k: v for k, v in raw.items() if k == JAX_META_KEY}
        raw[META_KEY] = {"kernel_version": cur}
        return raw

    def _load(self) -> Dict[str, Dict]:
        if self._entries is None and not self._persist:
            self._entries = {META_KEY: {"kernel_version": current_kernel_version()}}
        if self._entries is None:
            try:
                with open(self.path) as f:
                    raw = dict(json.load(f))
            except OSError:
                raw = {}
            except ValueError as e:
                self._quarantine_corrupt(e)
                raw = {}
            self._entries = self._check_version(raw)
        return self._entries

    def _locked(self):
        """Advisory lock around the read-merge-replace of `_save`."""
        if fcntl is None:  # pragma: no cover - non-posix platform
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def hold():
            lf = open(self.path + ".lock", "a")
            try:
                fcntl.flock(lf, fcntl.LOCK_EX)
                yield
            finally:
                try:
                    fcntl.flock(lf, fcntl.LOCK_UN)
                finally:
                    lf.close()

        return hold()

    def _save(self, drop_keys: Tuple[str, ...] = ()) -> None:
        self.resolved.clear()
        if not self._persist:
            for k in drop_keys:
                self._load().pop(k, None)
            return
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        with self._locked():
            # merge the file's current contents under ours: another process
            # may have persisted winners since our _load
            entries = dict(self._entries or {})
            try:
                with open(self.path) as f:
                    on_disk = dict(json.load(f))
                meta = on_disk.get(META_KEY)
                stamped = meta.get("kernel_version") if isinstance(meta, dict) else None
                if stamped is None or int(stamped) == current_kernel_version():
                    on_disk.update(entries)
                    entries = on_disk
            except OSError:
                pass
            except ValueError as e:
                self._quarantine_corrupt(e)
            for k in drop_keys:
                entries.pop(k, None)
            entries[META_KEY] = {"kernel_version": current_kernel_version()}
            self._entries = entries
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(entries, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # ---------------- API ----------------

    def get(self, m: int, n: int, k: int, dtype, backend: str, op: str = NS_GEMM) -> Optional[Knobs]:
        entries = self._load()
        device = self.device_of(backend)
        d = entries.get(self.key(m, n, k, dtype, backend, op, device))
        if d is None and device:
            # legacy fallback: entries written without a device kind
            d = entries.get(self.key(m, n, k, dtype, backend, op))
        if d is None:
            obs_metrics.inc("tune.cache.miss", op=op, backend=backend)
            return None
        obs_metrics.inc("tune.cache.hit", op=op, backend=backend)
        return dataclasses.replace(Knobs.from_dict(d), source="cached")

    def put(self, m: int, n: int, k: int, dtype, backend: str, knobs: Knobs, op: str = NS_GEMM) -> None:
        self._load()[self.key(m, n, k, dtype, backend, op, self.device_of(backend))] = knobs.as_dict()
        self._save()

    def _platform_keys(self, backend: str) -> Tuple[str, ...]:
        return tuple(dict.fromkeys((self.platform_key(backend, self.device_of(backend)),
                                    self.platform_key(backend))))

    def get_platform(self, backend: str) -> Optional[Dict]:
        """This device's persisted platform constants (the device-less entry
        as fallback), or None.  An entry stamped by another kernel
        generation, or unstamped, is purged (warned once) so that
        calibration re-fits."""
        entries = self._load()
        cur = current_kernel_version()
        for key in self._platform_keys(backend):
            d = entries.get(key)
            if d is None:
                continue
            d = dict(d)
            stamped = d.pop("kernel_version", None)
            if stamped is not None and int(stamped) == cur:
                return d
            del entries[key]
            self._save(drop_keys=(key,))
            obs_metrics.inc("tune.cache.platform_purge", backend=backend)
            warn_key = (self.path, backend)
            if warn_key not in _WARNED_PLATFORM:
                _WARNED_PLATFORM.add(warn_key)
                warnings.warn(
                    f"platform constants for {backend!r} in {self.path} were calibrated against kernel "
                    f"version {stamped if stamped is not None else '<unstamped>'} (current {cur}); purged, "
                    "re-calibrating",
                    RuntimeWarning,
                    stacklevel=3,
                )
        return None

    def purge_platform(self, backend: str) -> bool:
        """Drop this device's persisted platform constants so the next
        `calibrate` re-fits.  Returns True when an entry was removed."""
        entries = self._load()
        drop = tuple(k for k in self._platform_keys(backend) if k in entries)
        if not drop:
            return False
        for k in drop:
            del entries[k]
        self._save(drop_keys=drop)
        obs_metrics.inc("tune.cache.platform_purge", backend=backend)
        return True

    def put_platform(self, backend: str, constants: Dict) -> None:
        self._load()[self.platform_key(backend, self.device_of(backend))] = dict(
            constants, kernel_version=current_kernel_version()
        )
        self._save()

    def get_health(self) -> Dict[str, Dict]:
        """Persisted fallback-ladder quarantine records (key -> dict)."""
        return {
            k[len(HEALTH_PREFIX):]: dict(v)
            for k, v in self._load().items()
            if k.startswith(HEALTH_PREFIX) and isinstance(v, dict)
        }

    def put_health(self, state: Dict[str, Dict]) -> None:
        """Persist quarantine records: a full replacement, so records lifted
        since the last save leave the file too."""
        entries = self._load()
        keep = {HEALTH_PREFIX + k for k in state}
        drop = tuple(k for k in entries if k.startswith(HEALTH_PREFIX) and k not in keep)
        for k in drop:
            del entries[k]
        for key, rec in state.items():
            entries[HEALTH_PREFIX + key] = dict(rec)
        self._save(drop_keys=drop)

    def clear(self) -> None:
        self._entries = {}
        self.resolved.clear()
        if not self._persist:
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __len__(self) -> int:
        # knob and platform entries only: the stamps and health records are
        # bookkeeping, not tuning results
        return sum(
            1 for k in self._load()
            if k not in (META_KEY, JAX_META_KEY) and not k.startswith(HEALTH_PREFIX)
        )
