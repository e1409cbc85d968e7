"""Deterministic synthetic data pipelines (host-side numpy copies of
``repro.data``): the GNN shape cells' graph batches (:mod:`.graphs`) and
the LM archs' synthetic token batches (:mod:`.tokens`) and the recsys
arch's Zipf click log (:mod:`.recsys`).

Every pipeline is a pure function of its arguments and seed, so a seed
gives byte-identical batches in both packages.
"""
