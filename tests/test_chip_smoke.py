"""chip_smoke.py: it refuses to run without a GPU, and its phases (the
GPU run's checks) pass at tiny sizes on the CPU backend."""

import chip_smoke


def test_main_refuses_cpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phases_tiny_on_cpu(tmp_path):
    tmp = str(tmp_path)
    # > 2^16 records so the deep-bin case overflows the packed scatter
    chip_smoke.phase_kernels(n_records=80_000, n_bins=4096, n_contigs=30)
    inputs = chip_smoke.make_main_inputs(tmp, n_records=20_000, n_contigs=30)
    res = chip_smoke.phase_main_path(tmp, inputs, card="cpu")
    assert res["counters"]["hits"] == len(inputs["w"]["read_id"])
    chip_smoke.phase_stream(tmp, inputs, res["out"], chunk=4096)
    chip_smoke.phase_directory(tmp, n_files=3, n_records=2000, n_contigs=10)
