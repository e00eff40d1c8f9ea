"""The plain reference of the output check: NumPy, written for the
benchmark from the semantics of each layer, and sharing no code with
the program.  It reads the panel and the reads that the harness made,
and reads the program's outputs and captured state only to judge them:

  exact   which panel alleles hold each read pair exactly (both mates),
          and which reads carry panel k-mers;
  screen  the extraction's verdicts against those facts;
  groups  read groups, equivalence classes and the EM's read-group
          table worked out again from the program's read groups;
  band    the deferred band items' match counts where the optimal
          banded alignment is the ungapped one;
  em      T1K's SQUAREM EM over an equivalence-class problem, in float64
          or (the control) float32.

Nothing here imports jax, jaxlib, t1k_tpu or t1k_tpu_torch."""
