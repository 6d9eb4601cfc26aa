"""The port's tutorials: one module per script of tutorials/.

Each runs as ``python -m pyc2ray_torch.tutorials.<name>`` with the JAX
script's arguments and defaults, plus ``--device`` (``cuda`` by default,
``cpu`` for the plain PyTorch path) and ``--workdir`` (they write
nothing), and prints the JAX script's lines.

    chemistry_solver   tutorials/chemistry_solver.py
    raytracing         tutorials/raytracing.py
    helium_thermal     tutorials/helium_thermal.py
"""
