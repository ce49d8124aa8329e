"""The port's multi-device dry run (nanocall_tpu_torch.dryrun, the
counterpart of __graft_entry__.py:68 dryrun_multichip) on eight CPU
"devices": the placed EM round (bit-equal to the unplaced one), the placed
generic and production decodes, K9's equality and the sharded pipeline's
FASTA equality, with the JAX dry run's summary line."""

import re

import pytest
import torch

from nanocall_tpu_torch import dryrun
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_cpu_devices(n, capsys):
    """n = 8: a 4 x 2 mesh; n = 3: odd, so a 3 x 1 mesh, as the JAX dry run
    cuts it.  The summary line is JAX's, and the last line printed."""
    line = dryrun.dryrun_multichip(n, devices=[CPU] * n)
    D, M = (4, 2) if n == 8 else (3, 1)
    assert line == (
        f"dryrun_multichip ok: mesh={{'data': {D}, 'model': {M}}} train "
        f"G={2 * D} decode B={2 * D} pooled_decode B={2 * D} "
        f"seqpar_exact=True pipeline_fasta_equal=True")
    assert capsys.readouterr().out.splitlines()[-1] == line
    assert re.fullmatch(r"dryrun_multichip ok: mesh=\{.*\} train G=\d+ "
                        r"decode B=\d+ pooled_decode B=\d+ seqpar_exact=True "
                        r"pipeline_fasta_equal=True", line)


def test_dryrun_needs_a_gpu_or_devices(monkeypatch):
    """Without devices= it runs on the visible GPUs, and without one it
    raises; more devices than given raise too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="GPU"):
        dryrun.main(["2"])
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun.dryrun_multichip(4, devices=[CPU] * 2)
