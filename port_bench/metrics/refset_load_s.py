"""refset_load_s: seconds per sample in io/refset.py RefSet.from_fasta
(the harness span), summed over the chain's stages: each stage loads
the reference and compares every pair of genes."""


def read(run):
    return run.span_mean("refset_load")
