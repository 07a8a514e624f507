"""Canonical usage script of the PyTorch / CUDA port (the port's copy of
run_mad_tpu.py), on the card:

    python3 run_mad_tpu_torch.py

The reference's documented experimental configurations translate 1:1
onto ``mad_tpu_torch.api.MaD`` (same knob names, same defaults):

    # 6dbl, 5 A
    mad.add_map("experimental_data/6dbl/emd_7845_processed.mrc", 5)
    mad.add_subunit("experimental_data/6dbl/6dbl_subA.pdb", n_copies=1)
    mad.add_subunit("experimental_data/6dbl/6dbl_subB.pdb", n_copies=2)
    mad.add_subunit("experimental_data/6dbl/6dbl_subC.pdb", n_copies=1)
    mad.run(); mad.build_assembly()

    # 2p4n, 9 A:  mad.run(cc_threshold=0.5, n_samples=80)
    # 3j3u, 10 A: mad.run(n_samples=100, cc_threshold=0.5)
    # 5kuh, 11.6 A: mad.run(patch_size=24)
    # 4ckd, 13 A: mad.run(n_samples=120, patch_size=12)

Without the (unshipped) experimental data, this script demonstrates the
full pipeline on a synthetic self-fit assembly: simulate a trimer map,
decoy-transform the subunit, dock it back and build assembly models.
"""

from mad_tpu_torch.demo import main

if __name__ == "__main__":
    # in place like the reference's script (artifacts in the CWD)
    main(workdir=".")
