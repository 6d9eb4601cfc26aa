"""Convert original-C2Ray/CubeP3M text source catalogs to HDF5.

Equivalent of the reference's utils/source_converter.py:1-64: reads a
C2Ray-format source list ('<z>-coarsest_wsubgrid_sources.dat': first line
count, then rows "i j k mass_hm mass_lm ..."), writes an HDF5 file with
'sources_positions' (1-indexed) and 'sources_mass' datasets, optionally
sorted by mass descending.

Usage: python -m pyc2ray_torch.utils.source_converter in.dat out.hdf5 [--sort]
"""

import argparse

import numpy as np

__all__ = ["convert_source_file"]


def convert_source_file(infile, outfile, mass_column=3, sort=False):
    import h5py
    with open(infile) as f:
        data = np.loadtxt(f, skiprows=1, ndmin=2)
    pos = data[:, 0:3].astype(np.int64)
    mass = data[:, mass_column].astype(np.float64)
    if sort:
        order = np.argsort(mass)[::-1]
        pos, mass = pos[order], mass[order]
    with h5py.File(outfile, "w") as f:
        f.create_dataset("sources_positions", data=pos)
        f.create_dataset("sources_mass", data=mass)
    return pos.shape[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--sort", action="store_true")
    p.add_argument("--mass-column", type=int, default=3)
    args = p.parse_args()
    n = convert_source_file(args.infile, args.outfile, args.mass_column,
                            args.sort)
    print(f"wrote {n} sources to {args.outfile}")


if __name__ == "__main__":
    main()
