"""chip_smoke.py's CPU-checkable parts: it refuses to run without a GPU,
prints the result line in its exact format, and its chain, streaming and
four-card phases pass here at tiny sizes (the same code runs on the card)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=120, env=env, cwd=cwd,
    )


class TestRefusal:
    def test_cpu_platform_exits_nonzero_without_result(self):
        p = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
        assert p.returncode != 0
        assert "no GPU" in p.stderr
        assert '"ok"' not in p.stdout

    def test_alone_in_a_directory_exits_nonzero(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        env = {"PYTHONPATH": ""}
        p = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path), env)
        assert p.returncode != 0
        assert '"ok"' not in p.stdout

    def test_four_cards_needs_four_gpus(self):
        p = _run([os.path.join(REPO, "chip_smoke.py"), "--four-cards"], REPO)
        assert p.returncode != 0
        assert '"ok"' not in p.stdout


class TestResultLine:
    @pytest.mark.parametrize("count", [1, 4])
    def test_exact_format(self, count):
        line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", count)
        assert line == (
            '{"ok": true, "device": {"platform": "gpu", "kind": '
            f'"NVIDIA H100 80GB HBM3", "count": {count}}}}}'
        )
        assert json.loads(line)["device"]["count"] == count


class TestReferences:
    @pytest.mark.parametrize("n", [0, 1, 999_999, 1_000_000, 2_500_001])
    def test_patterned_checksum_closed_form(self, n):
        i = np.arange(n, dtype=np.uint64)
        want = {
            "count": n,
            "barcode_sum": int((i % np.uint64(1_000_000)).sum(dtype=object)),
            "umi_sum": int((i * np.uint64(2)).sum(dtype=object)),
            "index_sum": int(i.sum(dtype=object)),
        }
        assert chip_smoke.patterned_checksum(n) == {
            k: v & chip_smoke.U64 for k, v in want.items()
        }

    def test_histogram_text_roundtrip(self):
        text = "ACGTACGTACGTACGT\t5\nAAAAAAAAAAAAAAAA\t2\n"
        from ibu_jax.ops import codec as C

        got = chip_smoke.read_histogram(text)
        want = C.encode_seqs(["ACGTACGTACGTACGT", "AAAAAAAAAAAAAAAA"])
        assert got == {int(want[0]): 5, int(want[1]): 2}
        assert chip_smoke.read_histogram("") == {}


class TestPhasesOnCpu:
    def test_chain_matches_planted_truth(self, tmp_path):
        seconds = chip_smoke.run_chain(str(tmp_path), cells=40, reads=20_000,
                                       genes=20, error_rate=0.2, seed=3)
        assert set(seconds) >= {"ingest-fastq", "cells", "correct", "sort",
                                "dedup", "count", "verify"}
        assert "IBU_AUTO_ENGINE" not in os.environ

    def test_streaming_matches_references(self, tmp_path):
        seconds = chip_smoke.run_streaming(str(tmp_path), 60_000)
        assert set(seconds) >= {"stats", "histogram", "sort --engine device",
                                "sort reference"}

    def test_four_card_paths_on_virtual_devices(self, tmp_path):
        seconds = chip_smoke.run_four_cards(str(tmp_path), 300_000)
        assert set(seconds) >= {"sort --engine mesh", "stats", "histogram"}


@pytest.mark.gpu
def test_validation_matrix_compiled_for_the_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; `python chip_smoke.py` runs this "
                    "matrix on the card")
    from ibu_jax.validate import run_matrix

    assert all(ok for _, ok in run_matrix())
