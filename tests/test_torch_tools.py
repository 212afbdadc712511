"""The parts of the port's card tools that need no card:
``tools/phase_clocks.py``'s stamped kernel sources and ptxas report,
``tools/kernel_ab.py``'s summary of an A/B's arms, and the card default of
``tools/esdirk_steps.py``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("source, marks, stamp", [
    ("phi_tables_wide.cu", "MARKS", "MARK("),
    ("phi_tables.cu", "TABLE_MARKS", "PHASE("),
])
def test_stamps_apply_to_the_kernel_sources(source, marks, stamp):
    """Every phase marker finds its text in the kernel source exactly once,
    so a change to a kernel that moves a marked line fails here first."""
    pc = tool("phase_clocks")
    marks = getattr(pc, marks)
    src = pc.stamped(source, marks, pc.CLOCK_PRELUDE if stamp == "PHASE(" else "")
    plain = (pc.ROOT / "phoskintime_tpu_torch/csrc" / source).read_text()
    added = src.count(stamp) - plain.count(stamp) - pc.CLOCK_PRELUDE.count(stamp) * (stamp == "PHASE(")
    assert added == sum(new.count(stamp) - old.count(stamp) for old, new in marks) > 0


def test_stamps_refuse_a_changed_source():
    pc = tool("phase_clocks")
    with pytest.raises(SystemExit, match="text changed"):
        pc.stamped("phi_tables.cu", [("no such line in the kernel", "")])


def test_register_report_reads_each_instance():
    pc = tool("phase_clocks")
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__x_13_phi_tables_cu_y17phi_tables_kernelIfLi6EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__x_13_phi_tables_cu_y17phi_tables_kernelIdLi8EEEvPKT_' for 'sm_90a'",
        "ptxas info    : 1408 bytes stack frame, 3824 bytes spill stores",
        "ptxas info    : Used 255 registers, used 0 barriers",
    ])
    assert pc.register_report(log) == {
        "float32 w=6": "Used 128 registers, used 0 barriers",
        "float64 w=8": "Used 255 registers, used 0 barriers"}


def test_ab_spread_is_median_least_most_per_tree():
    ab = tool("kernel_ab")
    arms = [{"tree": t, "flux": {"x": {"device_ms": v, "host_us": h, "digest": ("a", "b")}}}
            for t, v, h in [("parent", 3.0, 30.0), ("change", 1.0, 10.0), ("change", 2.0, None),
                            ("parent", 5.0, 20.0), ("parent", 4.0, 25.0)]]
    assert ab.spread(arms, "parent", "flux") == {
        "x": {"device_ms": (4.0, 3.0, 5.0), "host_us": (25.0, 20.0, 30.0)}}
    assert ab.spread(arms, "change", "flux") == {
        "x": {"device_ms": (1.5, 1.0, 2.0), "host_us": (10.0, 10.0, 10.0)}}


def test_esdirk_steps_runs_on_the_card_unless_asked(monkeypatch):
    """Without ``--device`` the tool takes the card, and where there is
    none it raises before it builds anything, as the port's entry points."""
    steps = tool("esdirk_steps")
    monkeypatch.setattr(steps.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(steps, "build_demo_network", lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr("sys.argv", ["esdirk_steps.py", "--t-end", "0.01"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.main()
