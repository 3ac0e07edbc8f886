"""Every cell through the harness at a tiny size on the port's CPU path:
the run agrees with the reference, and turns out not correct when the
timed path is broken underneath or the control stands in for it."""

import time

import numpy as np
import pytest
import torch

from chipbench.harness import drive, faults, main, registry

ROOT = registry.BENCH_DIR.rsplit("/", 1)[0]
BENCH = registry.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [w["name"] for w in BENCH["workloads"]
         if registry.load_mix(w["traffic"])["drive"] != "calibrate"]
CALIB = [w["name"] for w in BENCH["workloads"]
         if registry.load_mix(w["traffic"])["drive"] == "calibrate"]
USERS = 64


def run(cell, seed=2**31 + 11):
    return main.run_cell(BENCH, registry.workload(BENCH, cell), seed, 0.2,
                         False, "cpu", time.perf_counter(), n_users=USERS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees(cpu_port, cell):
    result, lines = run(cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in registry.metrics_for(BENCH, cell,
                                                    "end_to_end")}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "check"
    assert lines[-1] == "correct: True"
    for name, c in result["check"].items():
        assert 0 <= c["value"] <= c["limit"]


def made(dmt, cell, seed, n_users):
    """The cell's drive after set-up, one call and ``release``."""
    w = registry.workload(BENCH, cell)
    mix = registry.load_mix(w["traffic"])
    with drive.program_config(dmt, mix):
        d = drive.make(dmt, registry.load_config(w["config"]), mix, seed,
                       "cpu", n_users)
        d.setup()
        d.call()
        d.release()
    return d


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cpu_port, cell):
    mk = [made(cpu_port, cell, 5, USERS) for _ in range(2)]
    for a, b in zip(mk[0].parts, mk[1].parts):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("fault", faults.SERVING)
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(cpu_port, cell, fault):
    undo = faults.plant(fault, cpu_port)
    try:
        result, lines = run(cell)
    finally:
        undo()
    assert not result["correct"] and result["failed"] >= 1, lines


@pytest.mark.parametrize("fault", faults.TRAINING)
@pytest.mark.parametrize("cell", CALIB)
def test_training_fault_is_not_correct(cpu_port, cell, fault):
    undo = faults.plant(fault, cpu_port)
    try:
        result, lines = run(cell)
    finally:
        undo()
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cpu_port, cell):
    """The reference in TF32 in the program's place fails a limit that the
    program meets, at 256 users."""
    d = made(cpu_port, cell, 2**31 + 3, 256)
    limits = main.load_limits(cell)
    program, control = d.numbers(), d.numbers(control=True)
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control


def test_calibration_checked_after_the_window(cpu_port):
    """The steps after the window start where the window left the state,
    and the reference follows them from there."""
    d = made(cpu_port, CALIB[0], 7, USERS)
    moved = [(a - b).abs().max() for a, b in zip(d.after["start"],
                                                 d.first["last"])]
    assert max(moved) > 0
    numbers = d.numbers()
    assert {k + "_after" for k in numbers if not k.endswith("_after")} \
        <= set(numbers)
    limits = main.load_limits(CALIB[0])
    assert all(numbers[k] <= v for k, v in limits.items()), numbers


def test_calibration_step_and_backend_from_the_mix(cpu_port):
    """A mix names the step and the program's settings: the complex-loss
    step on the path-sum backend runs as data alone."""
    w = registry.workload(BENCH, CALIB[0])
    mix = dict(registry.load_mix(w["traffic"]), step="training_step",
               program_config={"render_backend": "pallas",
                               "planes_layout": "stacked"})
    with drive.program_config(cpu_port, mix):
        d = drive.make(cpu_port, registry.load_config(w["config"]), mix, 3,
                       "cpu", USERS)
        d.setup()
        assert d.cfg.backend == "pallas" and d.target.is_complex()
        d.call()
        d.release()
    assert cpu_port.config.get("render_backend") == "fused"
    numbers = d.numbers()
    # float32 grade; a cell on this step sets its limits from its readings
    assert all(v <= 1e-5 for k, v in numbers.items()
               if "loss" in k or "median" in k), numbers


def test_reference_feature_from_its_file(cpu_port):
    """A dipole BS panel: the reference takes the pattern from
    reference/pattern.halfwave-dipole.py and agrees with the port."""
    w = registry.workload(BENCH, "mimo64.serve_device")
    config = registry.load_config(w["config"])
    config["channel_params"]["bs_antenna"]["radiation_pattern"] = \
        "halfwave-dipole"
    mix = registry.load_mix(w["traffic"])
    from chipbench.reference import channels as ref
    assert ref.features(config["channel_params"]) == [
        "pattern.halfwave-dipole"]
    d = drive.make(cpu_port, config, mix, 11, "cpu", USERS)
    d.setup()
    d.call()
    d.release()
    assert d.numbers()["channels_rel_err"] <= main.load_limits(
        "mimo64.serve_device")["channels_rel_err"]
    plain = drive.make(cpu_port, registry.load_config(w["config"]), mix, 11,
                       "cpu", USERS)
    plain.setup()
    h = d.results[d.history[-1]]
    assert not torch.equal(h, plain.results[plain.history[-1]])


def test_reference_feature_without_a_file():
    from chipbench.reference import channels as ref
    params = registry.load_config("asu_campus_quickstart")["channel_params"]
    params = dict(params, enable_doppler=1)
    with pytest.raises(NotImplementedError, match="reference/doppler.py"):
        ref.stages(params)


def test_path_counts_weighted_from_the_mix():
    from chipbench.harness import inputs
    mix = dict(registry.load_mix("serve_device"), valid_paths=[1, 4],
               valid_paths_weights=[0, 1, 0, 3])
    counts = inputs.path_matrices(4000, 25, 9, mix)["n_valid"]
    assert set(np.unique(counts)) == {2, 4}
    assert 0.7 < np.mean(counts == 4) < 0.8
    data = inputs.path_matrices(10, 25, 9, dict(mix, ranges=dict(
        mix["ranges"], doppler_vel=[-30, 30])))
    assert np.isnan(data["doppler_vel"][:, 4:]).all()


def test_tf32_rounding():
    from chipbench.reference.channels import tf32
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12,
                      -3.0 - 2**-10], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10,
                                -3.0 - 2**-9]
