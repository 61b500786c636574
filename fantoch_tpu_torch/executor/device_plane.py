"""DevicePlane: the shared base of every device-resident executor plane.

The port of fantoch_tpu/executor/device_plane.py.  A plane keeps its state
on the card across batches and updates it in place with one fused dispatch
per batch (what JAX's buffer donation did); this base owns the machinery
every plane shares:

* **resident tensors** — :meth:`_upload` is the ONE place resident state
  is created: every host array is copied into a tensor on the plane's
  device (``torch.tensor(..., device=)``, never an alias of host numpy,
  since the dispatch then writes into it) and the upload is counted.
* **lazy host-mirror re-materialization** — pickling (the restart plane's
  ``Executor.snapshot`` seam) fetches the resident state into a host
  mirror (``.cpu().numpy()`` copies); device state never survives a
  pickle, and the next dispatch re-materializes from the mirror with
  exactly ONE counted upload (``resident_uploads``).
* **residual re-feed** — work a dispatch could not finish comes back as
  residual columns, buffered host-side and prepended to the next feed, or
  stays resident until a later feed unblocks it.
* **per-dispatch counters** — dispatches / occupancy / residual work /
  kernel wall-ms, surfaced through ``Executor.device_counters()``; and
  each dispatch's device time (CUDA events on a card, the host clock on
  the CPU), folded into ``observability/device.py``'s counters.
* **kernel-threshold switches** — config > env > built-in default
  (:func:`resolve_threshold`).

Capacity follows a pow2 schedule (``_grow`` doubles); growth of a live
resident state is one fetch + pad + counted re-upload.

**Accelerator fault detection**: a health gauge (healthy -> failed) and a
*host twin* used only as a detector.  Arming the plane
(``Config.device_dispatch_timeout_ms`` or ``Config.plane_shadow_rate``)
makes every dispatch log its exact padded kernel inputs; the twin folds
that log on demand by replaying it through the plain PyTorch version of
the same step on CPU tensors.  The kernels and their plain versions
agree bit for bit, so the twin's outputs are what a healthy card would
have produced:

* a dispatch that overruns the deadline raises ``DeviceFailedError``;
* the sampled **shadow check** compares the fetched resident post-state
  and the dispatch's outputs with the twin's, and a mismatch raises
  ``DeviceCorruptionError`` naming the first diverging row — before any
  host bookkeeping consumes the outputs.

**Fault injection**: an attached
:class:`~fantoch_tpu_torch.sim.device_faults.DeviceFaultInjector` is
consulted before each fused dispatch (and arms the plane).  A ``hang``
or ``raise`` fault raises ``DeviceFailedError`` before that dispatch's
kernels launch (short-circuiting a hung dispatch *is* its deadline); a
``corrupt`` fault flips one bit of resident state array 0 on the card
after the kernels ran, which the shadow check then names.

Either error marks the plane failed, calls the attached failure listener
(the sim runner records it and dumps the flight ring) and goes to the
caller: the round is never served from the twin, and a failed plane
refuses every later dispatch (and a snapshot), so a slow or wrong kernel
cannot hide behind its plain version.  Recovery is the caller's: restore
an executor from a snapshot taken while healthy.  Unarmed (the default),
none of this costs anything.

**Device.**  A plane runs on ``device`` (default ``cuda``); without CUDA
and without an explicit device it raises rather than run on the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from fantoch_tpu_torch.core.kvs import Key
from fantoch_tpu_torch.errors import DeviceCorruptionError, DeviceFailedError
from fantoch_tpu_torch.observability.device import DispatchTimer, record_dispatch

# plane health gauge (numeric so a pool can max-fold it: worst state
# wins; the values are the reference package's gauge values)
HEALTH_HEALTHY = 0
HEALTH_FAILED = 3
HEALTH_NAMES = {HEALTH_HEALTHY: "healthy", HEALTH_FAILED: "failed"}

# armed planes fold the twin log once it holds this many dispatches, so
# an armed-but-never-checked run pays bounded host memory (folding is
# the plain version replayed on host-owned state)
TWIN_FOLD_LIMIT = 64


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the shared padding schedule of every
    plane (capacities, widths, feed columns)."""
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_device(device=None) -> torch.device:
    """The plane's device: the caller's, else ``cuda``.  Without CUDA and
    without an explicit device this raises — a plane never carries on
    quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the plane "
            "on the CPU"
        )
    return torch.device("cuda")


def resolve_threshold(
    explicit: Optional[int], env_var: str, default: int
) -> int:
    """The shared threshold-knob resolution: an explicit config value
    beats the environment variable beats the built-in default (the
    ``Config.table_kernel_threshold`` precedence, extracted so every
    plane's switches resolve the same way)."""
    if explicit is not None:
        return int(explicit)
    env = os.environ.get(env_var)
    if env:
        return int(env)
    return default


class DevicePlane:
    """Resident device state + fused dispatch per batch: the base class.

    Subclasses define the state as a tuple of host numpy arrays via three
    hooks and get buffer lifecycle, durability and counters for free:

    * :meth:`_fresh_state` — zero state at the current capacity;
    * :meth:`_pad_state` — existing host state re-padded to a (larger)
      capacity (called by :meth:`_grow` and mirror re-materialization);
    * the resident state itself is ``self._resident`` (a tuple of
      tensors on the plane's device, or None while unmaterialized) —
      dispatch methods call :meth:`_materialize` first and the kernels
      update the tuple in place.

    The optional key registry (``bucket``) maps string keys to stable
    device row ids with pow2 capacity; planes keyed by something else
    (the pred plane's dot->slot map) drive ``_grow`` directly.
    """

    __slots__ = (
        "_key_index",
        "_keys",
        "_device",
        "_cap",
        "_resident",
        "_host_mirror",
        "_residuals",
        "dispatches",
        "grows",
        "resident_uploads",
        "stats",
        "_timers",
        # --- accelerator fault detection ---
        "health",
        "plane_failures",
        "last_failure",
        "_fault_pid",
        "_fault_seed",
        "_shadow_rate",
        "_timeout_ms",
        "_fault_armed",
        "_twin_state",
        "_twin_log",
        "_injector",
        "_failure_listener",
    )

    # subclasses name themselves in errors
    plane_name = "device"

    def __init__(self, capacity: int, stats: Dict[str, float], device=None):
        self._device = resolve_device(device)
        self._key_index: Dict[Key, int] = {}
        self._keys: List[Key] = []
        self._cap = next_pow2(max(capacity, 2))
        # tuple of device tensors; None = lazy (created on first dispatch)
        self._resident = None
        # host copy awaiting re-materialization (restart/unpickle path);
        # None while the live state is device-resident
        self._host_mirror: Optional[Tuple[np.ndarray, ...]] = None
        # host-buffered residual columns re-fed with the next batch
        self._residuals: Tuple[np.ndarray, ...] = ()
        self.dispatches = 0
        self.grows = 0
        # host->device materializations: 1 for the lazy initial upload,
        # +1 per restore-from-snapshot re-upload and per live grow (the
        # recovery acceptance signal: restart costs ONE upload, not one
        # per batch)
        self.resident_uploads = 0
        # per-dispatch observability tallies (observability/device.py)
        self.stats: Dict[str, float] = dict(stats)
        # the device-time brackets of the dispatch being counted
        self._timers: List[DispatchTimer] = []
        self._reset_faults()

    # --- state hooks (subclass responsibility) ---

    def _fresh_state(self) -> Tuple[np.ndarray, ...]:
        """Zero host state at the current capacity."""
        raise NotImplementedError

    def _pad_state(
        self, state: Tuple[np.ndarray, ...], cap: int
    ) -> Tuple[np.ndarray, ...]:
        """``state`` re-embedded into fresh arrays at capacity ``cap``
        (>= the state's own capacity)."""
        raise NotImplementedError

    # --- key registry (string keys -> stable device rows; optional) ---

    def bucket(self, key: Key) -> int:
        idx = self._key_index.get(key)
        if idx is None:
            idx = len(self._keys)
            self._key_index[key] = idx
            self._keys.append(key)
            if idx >= self._cap:
                self._grow()
        return idx

    @property
    def key_count(self) -> int:
        return len(self._keys)

    # --- buffer lifecycle ---

    def _upload(self, state: Tuple[np.ndarray, ...]) -> None:
        """THE resident-tensor creation point: copies every array into a
        tensor on the plane's device (never an alias of host numpy: the
        dispatch writes into it) and counts the upload."""
        self._resident = tuple(
            torch.tensor(a, device=self._device) for a in state
        )
        self.resident_uploads += 1

    def _fetch_state(self) -> Tuple[np.ndarray, ...]:
        """The whole resident tuple as host numpy copies."""
        assert self._resident is not None
        return tuple(
            t.to("cpu", copy=True).numpy() for t in self._resident
        )

    def _materialize(self) -> None:
        """Ensure the state is device-resident: lazy initial creation, or
        the ONE re-upload from the host mirror after restore-from-snapshot
        (the restart plane's lazy re-materialization seam)."""
        if self._resident is not None:
            return
        if self._host_mirror is not None:
            state = self._pad_state(self._host_mirror, self._cap)
            self._host_mirror = None
        else:
            state = self._fresh_state()
        self._upload(state)

    def _grow(self) -> None:
        """Double the capacity; pads the resident state when live (one
        host round-trip — rare, amortized by the pow2 schedule).  An
        armed plane's twin grows alongside."""
        new_cap = self._cap * 2
        if self._resident is not None:
            state = self._fetch_state()
            self._upload(self._pad_state(state, new_cap))
        if self._twin_state is not None:
            self._twin_fold()
            self._twin_state = self._pad_state(self._twin_state, new_cap)
        self._cap = new_cap
        self.grows += 1

    # --- residual re-feed (column-buffer variant) ---

    def _take_residuals(
        self, columns: Tuple[np.ndarray, ...]
    ) -> Tuple[np.ndarray, ...]:
        """Prepend the buffered residual columns to this batch's columns
        (so gap-filling batches coalesce with the runs they unblock) and
        clear the buffer; ``_put_residuals`` re-buffers the dispatch's
        leftover."""
        if not self._residuals:
            return columns
        merged = tuple(
            np.concatenate([r, c]) for r, c in zip(self._residuals, columns)
        )
        self._residuals = ()
        return merged

    def _put_residuals(self, columns: Tuple[np.ndarray, ...]) -> None:
        self._residuals = columns

    @property
    def residual_count(self) -> int:
        return len(self._residuals[0]) if self._residuals else 0

    # --- per-dispatch counters ---

    def _timer(self) -> DispatchTimer:
        """Start a device-time bracket for the kernels about to launch;
        the caller stops it once they are enqueued, and the dispatch's
        brackets fold into the device counters when it is counted."""
        timer = DispatchTimer(self._device).start()
        self._timers.append(timer)
        return timer

    def _count_dispatch(self, t0: float, **adds: float) -> None:
        """Tally one dispatch: wall time since ``t0`` into
        ``stats["kernel_ms"]`` plus any per-plane increments, and its
        device time (its blocking fetch has drained it) into the device
        counters."""
        self.dispatches += 1
        self.stats["kernel_ms"] += (time.perf_counter() - t0) * 1000.0
        for name, value in adds.items():
            self.stats[name] += value
        if self._timers:
            record_dispatch(self.plane_name, self._timers)
            self._timers = []

    # --- accelerator fault detection ---

    def _reset_faults(self) -> None:
        self.health = HEALTH_HEALTHY
        self.plane_failures = 0
        self.last_failure: Optional[BaseException] = None
        self._fault_pid: Optional[int] = None
        self._fault_seed = 0
        self._shadow_rate = 0.0
        self._timeout_ms: Optional[float] = None
        self._fault_armed = False
        # host-twin detector: folded host state + the unfolded dispatch log
        self._twin_state: Optional[Tuple[np.ndarray, ...]] = None
        self._twin_log: List = []
        # runtime wiring (the sim runner attaches both; never pickled)
        self._injector = None
        self._failure_listener = None

    def configure_faults(
        self, config, seed: int = 0, process_id: Optional[int] = None
    ) -> None:
        """Arm (or leave unarmed) the fault detector from the config: the
        per-dispatch deadline and the shadow-check rate.  Executors call
        this right after constructing the plane, before any dispatch."""
        self._timeout_ms = config.device_dispatch_timeout_ms
        self._shadow_rate = config.plane_shadow_rate
        self._fault_seed = seed
        if process_id is not None:
            self._fault_pid = process_id
        self._refresh_armed()

    def attach_injector(self, injector) -> None:
        """Attach a DeviceFaultInjector (sim/device_faults.py); arms the
        plane, so a corrupt fault has a twin to be caught against."""
        self._injector = injector
        self._refresh_armed()

    def attach_failure_listener(self, listener) -> None:
        """``listener(plane, exc)`` fires on every failure the plane
        detects, before the typed error goes to the caller — the sim
        runner wires it to the nemesis trace + flight-recorder dump."""
        self._failure_listener = listener

    def _refresh_armed(self) -> None:
        self._fault_armed = (
            self._injector is not None
            or self._shadow_rate > 0.0
            or self._timeout_ms is not None
        )

    def health_name(self) -> str:
        return HEALTH_NAMES[self.health]

    def _check_usable(self) -> None:
        """A failed plane refuses to dispatch: its resident state is not
        trusted and no other route serves the round."""
        if self.health == HEALTH_FAILED:
            raise DeviceFailedError(
                self.plane_name, self._fault_pid, "failed", self.dispatches,
                cause=self.last_failure,
            )

    def _fail(self, exc: BaseException):
        """Mark the plane failed, tell the failure listener, and raise
        ``exc`` to the caller."""
        self.health = HEALTH_FAILED
        self.plane_failures += 1
        self.last_failure = exc
        listener = self._failure_listener
        if listener is not None:
            listener(self, exc)
        raise exc

    # --- fault injection (an attached injector only) ---

    def _fault_check_pre(self):
        """Consult the injector before a fused dispatch's kernels launch.
        hang/raise faults fail the plane here, so that dispatch launches
        nothing (a hung dispatch never completes — short-circuiting it
        *is* its deadline, kept deterministic instead of sleeping the
        wall budget); a corrupt fault is returned for the caller to apply
        with :meth:`_poison_resident` once the kernels ran."""
        inj = self._injector
        if inj is None:
            return None
        fault = inj.on_dispatch(self.plane_name, self.dispatches)
        if fault is None:
            return None
        if fault.kind == "hang":
            self._fail(DeviceFailedError(
                self.plane_name, self._fault_pid, "hang",
                self.dispatches, self._timeout_ms,
            ))
        if fault.kind == "raise":
            self._fail(DeviceFailedError(
                self.plane_name, self._fault_pid, "raise", self.dispatches,
                cause=RuntimeError("injected device runtime error"),
            ))
        return fault

    def _poison_resident(self, fault) -> None:
        """Apply an injected corrupt fault: flip ``fault.bit`` of flat
        element 0 of resident state array 0, in place on the card.
        Callers apply it AFTER the dispatch's resident update (a
        post-compute memory flip), so the kernels cannot overwrite the
        flipped cell in the same round and a rate-1.0 shadow check
        catches it on the faulted dispatch; the host twin never sees the
        flip, which is exactly why the compare names it."""
        state = self._resident[0]
        state.view(-1)[:1].bitwise_xor_(1 << fault.bit)

    # --- host twin (armed only; a detector, never a server) ---

    def _twin_replay(self, state, entry):
        """Replay ONE logged dispatch on host-owned ``state``: run the
        plain version of the plane's step on CPU tensors made from the
        state plus the entry's logged columns, and return ``(new_state,
        outputs)`` as host numpy."""
        raise NotImplementedError

    def _twin_note(self, entry) -> None:
        """Log one dispatch's exact padded kernel inputs for the twin
        (no-op unarmed), before the resident dispatch runs."""
        if not self._fault_armed:
            return
        if self._twin_state is None:
            self._twin_init()
        self._twin_log.append(entry)
        if len(self._twin_log) > TWIN_FOLD_LIMIT:
            self._twin_fold()

    def _twin_init(self) -> None:
        """First armed dispatch: the twin starts from the same state the
        resident plane did — fresh zeros, the restore mirror, or (when
        armed mid-life) a fetch of the current resident state."""
        if self._host_mirror is not None:
            self._twin_state = self._pad_state(self._host_mirror, self._cap)
        elif self._resident is not None:
            self._twin_state = self._fetch_state()
        else:
            self._twin_state = self._fresh_state()

    def _twin_fold(self):
        """Replay every logged dispatch, advancing the twin state; returns
        the LAST dispatch's outputs (None when the log was empty)."""
        outputs = None
        state = self._twin_state
        for entry in self._twin_log:
            state, outputs = self._twin_replay(state, entry)
        self._twin_state = state
        self._twin_log = []
        return outputs

    def _twin_resync(self, state: Tuple[np.ndarray, ...]) -> None:
        """Reset the twin to a host-derived state (compaction and the
        other host-mirror rebuilds produce trusted host state directly;
        the pending log described the pre-rebuild layout)."""
        if not self._fault_armed:
            return
        self._twin_state = tuple(np.array(a) for a in state)
        self._twin_log = []

    # --- detection: deadline, shadow-check ---

    def _check_deadline(self, t0: float) -> None:
        """The per-dispatch deadline, measured across the dispatch and
        its blocking fetch (a kernel launch cannot be interrupted
        portably; the fetch is when a hang becomes observable)."""
        if self._timeout_ms is None:
            return
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        if elapsed_ms > self._timeout_ms:
            self._fail(DeviceFailedError(
                self.plane_name, self._fault_pid, "timeout",
                self.dispatches, self._timeout_ms,
            ))

    def _shadow_sampled(self) -> bool:
        """Seeded per-dispatch shadow-check decision — a pure function
        of (seed, plane, dispatch #) so same-seed runs sample the same
        dispatches."""
        rate = self._shadow_rate
        if rate <= 0.0 or self._twin_state is None and not self._twin_log:
            return False
        if rate >= 1.0:
            return True
        import random

        draw = random.Random(
            f"{self._fault_seed}:{self.plane_name}:{self.dispatches}"
        ).random()
        return draw < rate

    def _shadow_compare(self, device_state, device_outputs) -> None:
        """Bit-for-bit compare the fetched resident post-state and the
        last dispatch's outputs (arrays numbered after the state's)
        against the twin's; a mismatch fails the plane with
        DeviceCorruptionError naming the first diverging row (and its
        key, when the row is in the key registry)."""
        twin_outputs = self._twin_fold()
        assert self._twin_state is not None and twin_outputs is not None
        pairs = list(zip(device_state, self._twin_state)) + list(
            zip(device_outputs, twin_outputs)
        )
        for index, (dev, host) in enumerate(pairs):
            if dev.shape == host.shape and np.array_equal(dev, host):
                continue
            if dev.shape != host.shape:
                row = 0
            else:
                diverging = np.nonzero(
                    (dev != host).reshape(dev.shape[0], -1).any(axis=1)
                )[0]
                row = int(diverging[0]) if len(diverging) else 0
            key = self._keys[row] if row < len(self._keys) else None
            self._fail(DeviceCorruptionError(
                self.plane_name, self._fault_pid, self.dispatches,
                index, row, key,
            ))

    def fault_counters(self) -> Dict[str, float]:
        """The fault slice of ``device_counters()`` (prefixed by the
        owning executor): failures detected and the health gauge."""
        return {"failures": self.plane_failures, "health": self.health}

    # --- durability (Executor.snapshot pickles through here) ---

    def _all_slots(self) -> List[str]:
        slots: List[str] = []
        for klass in type(self).__mro__:
            slots.extend(getattr(klass, "__slots__", ()))
        return slots

    def __getstate__(self):
        self._check_usable()
        state = {
            slot: getattr(self, slot)
            for slot in self._all_slots()
            if slot not in (
                "_resident", "_host_mirror", "last_failure", "_timers",
                "_injector", "_failure_listener",
            )
        }
        mirror = self._host_mirror
        if self._resident is not None:
            mirror = self._fetch_state()
        state["_host_mirror"] = mirror
        return state

    def __setstate__(self, state) -> None:
        self._reset_faults()
        self._timers = []
        for slot, value in state.items():
            setattr(self, slot, value)
        # device state never survives a pickle: the next dispatch
        # re-materializes from the host mirror (ONE counted upload)
        self._resident = None
