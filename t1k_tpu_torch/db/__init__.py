"""The database build of the port, counterparts of ``t1k_tpu/db/``: the
EMBL-ENA ``.dat`` -> allele FASTA builder (``parse_dat``, ``build``),
the coordinate FASTA (``add_gene_coord``), and the ``.dat`` generators
from VCF allele sets (``vcf_to_dat``), genome annotations
(``gtf_to_dat``) and cDNA variant panels (``variant_gene_db``).  Host
code only: its outputs equal the JAX package's byte for byte."""
