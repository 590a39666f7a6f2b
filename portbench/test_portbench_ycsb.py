"""The YCSB-C cell over 63-bit hashed keys (``ycsb20m.c``,
``drivers/ycsb_hashed.py``) on the CPU at a small size: the record keys
are YCSB's ``fnvhash64``, a sound run is correct, its control (the
reference at float64) and a program that rounds keys to float64 are
not, and each new metric reads a number, or None where a CPU run has
nothing to read; the cell's reference and yardstick import nothing of
the program."""

import numpy as np
import pytest
import torch

from portbench import harness, reference_u64, yardstick_u64
from portbench.test_portbench_manifest import _imports
from portbench.test_portbench_runs import SEED

CELL = "ycsb20m.c"
SMALL = {"config": {"n_keys": 60_000}, "mix": {"clients": 3,
                                               "read_keys": 256}}
NEW = {"serve_keys_per_dispatch.read": "number",
       "serve_queue_wait_ms.read": "number",
       "serve_flush_idle_ms.read": "number",
       "serve_dispatch_idle_ms.read": "number",
       "fused_lookup_u64_roofline.read": None}   # no CUDA kernel on a CPU
# the accepted metrics that read the cell too: the set-up's stages (the
# run's index), the device's idle share and the lookup stages' idle time
# (the ``lookup`` spans nest inside ``queue.dispatch``)
SHARED = ("build_s", "freeze_s", "build_learn_s", "build_place_s",
          "freeze_images_s", "freeze_upload_s", "freeze_bounds_s",
          "freeze_routers_s", "freeze_mirror_s", "device_idle.read",
          "lookup_idle_in_ms.read", "lookup_idle_launch_ms.read",
          "lookup_idle_fixup_ms.read", "lookup_idle_out_ms.read",
          "lookup_unstaged_idle.read")


@pytest.fixture(autouse=True)
def _in_process(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(harness, "leaked_modules", lambda: [])
    yield
    torch.set_num_threads(prev)


def _cell_module():
    return harness.load_module(harness.PB / "drivers" / "ycsb_hashed.py")


def _fnv_scalar(keynum: int) -> int:
    """YCSB's ``Utils.fnvhash64`` as written in Java, on Python ints:
    offset basis 0xCBF29CE484222325, prime 1099511628211, eight rounds
    of xor-then-multiply over the low byte, then ``Math.abs`` of the
    signed 64-bit result."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= keynum & 0xFF
        h = (h * 1099511628211) % (1 << 64)
        keynum >>= 8
    signed = h - (1 << 64) if h >= 1 << 63 else h
    return abs(signed) % (1 << 64)


@pytest.mark.parametrize("keynum", [0, 1, 2, 255, 256, 1000, 2 ** 31,
                                    19_999_999])
def test_keys_are_ycsb_fnvhash64(keynum):
    got = _cell_module().fnvhash64(np.array([keynum]))
    assert got.dtype == np.uint64 and int(got[0]) == _fnv_scalar(keynum)
    assert int(got[0]) < 2 ** 63


def test_record_keys_sorted_distinct_and_counted():
    keys, dups = _cell_module().record_keys(50_000)
    assert dups == 0 and keys.size == 50_000
    assert np.all(keys[1:] > keys[:-1])
    assert int(keys[0]) == min(_fnv_scalar(i) for i in range(50_000))


def test_sound_run_is_correct_and_traced_run_reads_every_metric():
    out = harness.execute(CELL, SEED, 0.5, False, device="cpu",
                          overrides=SMALL, log=lambda m: None)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"wrong_answers", "stale_reads",
                                  "neighbour_wrong"}
    cell = _cell_module()
    assert out["info"]["window"]["probe_answers"] == 2 * cell.PROBE_KEYS
    assert set(out["metrics"]) == {"setup_s", "device_memory_peak_gb"}
    win = out["info"]["window"]
    assert win["lookups_u64"] == win["queue"]["lookup_dispatches"] > 0
    assert win["engine"]["calls"] == win["lookups"]
    out = harness.execute(CELL, SEED, 0.5, True, device="cpu",
                          overrides=SMALL, log=lambda m: None)
    assert out["correct"], out["checks"]
    layer = {m["name"] for m in harness.cell_metrics(
        harness.manifest(), CELL)[1]}
    assert layer == set(NEW) | set(SHARED)
    for name in SHARED:
        assert out["metrics"][name]["value"] >= 0, name
    for name, kind in NEW.items():
        if kind is None:
            assert name not in out["metrics"]
        else:
            assert out["metrics"][name]["value"] >= 0, name
    assert out["metrics"]["serve_keys_per_dispatch.read"]["value"] >= 256


def test_control_is_not_correct():
    """The reference at float64 answers every present key right (no two
    of these keys share a float64) and nearly every neighbour wrong:
    only the neighbour probe tells it from the exact map."""
    out = harness.execute(CELL, SEED, 0.5, False, device="cpu",
                          control=True, overrides=SMALL,
                          log=lambda m: None)
    assert not out["correct"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["wrong_answers"] == 0 and checks["stale_reads"] == 0
    assert checks["neighbour_wrong"] > 0.99 * 2 * _cell_module().PROBE_KEYS


def test_a_program_that_rounds_keys_fails_cleanly(monkeypatch):
    """A program that takes 64-bit keys as float64 (as the index did
    before it held them exactly) is refused at the start of set-up,
    before the deployment's keys are drawn."""
    from repro_torch.core import keys64
    monkeypatch.setattr(keys64, "build_keys",
                        lambda keys: np.asarray(keys, np.float64))
    monkeypatch.setattr(keys64, "is_u64", lambda keys: False)
    with pytest.raises(RuntimeError, match="rounds 64-bit keys"):
        harness.execute(CELL, SEED, 0.5, False, device="cpu",
                        overrides=SMALL, log=lambda m: None)


def test_roofline_reader_counts_each_clients_reads():
    """``fused_lookup_u64_roofline.read`` over a synthetic run: reads
    listed client after client map to their pools' entries in turn."""
    import types
    keys = np.array([10, 20, 30, 40], np.uint64)
    pools = [[np.array([10, 11], np.uint64), np.array([20, 20], np.uint64)],
             [np.array([30, 40, 50], np.uint64)]]
    reads = [("read", 1.0), ("read", 2.0), ("read", 3.0),   # client 0
             ("read", 1.5), ("read", 2.5)]                  # client 1
    ev = types.SimpleNamespace(device_us=lambda s: 1e6 if "64" in s else 0)
    run = types.SimpleNamespace(events=ev, reads=reads, read_pools=pools,
                                keys=keys)
    reader = harness.load_module(
        harness.PB / "metrics" / "fused_lookup_u64_roofline.read.py")
    b = yardstick_u64.lookup_least_bytes_u64
    want = (2 * b(pools[0][0], keys) + b(pools[0][1], keys)
            + 2 * b(pools[1][0], keys))
    assert reader.read(run) == pytest.approx(
        100.0 * want / 3.35e12 / 1.0)
    assert want == 2 * (34 + 16) + (34 + 16) + 2 * (51 + 32)


def test_reference_and_yardstick_are_plain():
    for name in ("reference_u64.py", "yardstick_u64.py"):
        assert not set(_imports(harness.PB / name)) & {
            "repro_torch", "repro", "jax"}, name
    ref = reference_u64.PlainKV(np.array([2 ** 63 + 1, 2 ** 63], np.uint64),
                                np.array([5, 6]))
    pay, found = ref.answer(np.array([2 ** 63, 2 ** 63 + 1, 2 ** 63 + 2],
                                     np.uint64))
    assert pay.tolist() == [6, 5, -1] and found.tolist() == [True, True,
                                                             False]
