"""FASTA/FASTQ and BAM ingestion and the allele reference model of the
port."""
