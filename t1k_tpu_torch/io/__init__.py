"""FASTA/FASTQ ingestion and the allele reference model of the port."""
