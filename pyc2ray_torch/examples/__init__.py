"""The port's user drivers: one module per script of examples/.

Each runs as ``python -m pyc2ray_torch.examples.<name>`` with the JAX
script's arguments and defaults, plus ``--device`` (``cuda`` by default,
``cpu`` for the plain PyTorch path) and ``--workdir`` (where it writes; by
default where the JAX script writes). It prints the JAX script's lines,
checks and PASSED/FAILED verdicts and exits with its codes. The inputs
(``parameters.yml``, ``inputs/``) are read from ``examples/<name>/``.

    raytracing_benchmark   examples/raytracing_benchmark/run_test.py
    stromgren_ifront       examples/stromgren_ifront/run_test.py
    shadow_test            examples/shadow_test/run_test.py
    multisource            examples/multisource/run_test.py
    stromgren_cosmo        examples/stromgren_cosmo/run_test.py
    heating_test           examples/heating_test/run_test.py
    single_source_test     examples/single_source_test/run_test.py
    eor_simulation         examples/eor_simulation/run_test.py
    multihost_pod          examples/multihost_pod/run_test.py
    make_plots             examples/make_plots.py (needs matplotlib)

``eor_simulation --synthetic`` writes HDF5 catalogs and needs h5py; the
committed catalogs are read without it.
"""
