"""The user scripts of docs/guides.md, as modules of the port.

Each is the counterpart of the reference repository's script of the same
name in scripts/, run as `python -m octopus_tpu_torch.scripts.<name>`:

* long_phase: two-pass long-range phasing through the port's CLI;
* train_forest: the call-quality forest from annotated calls and a truth
  VCF, or from simulated samples;
* split_realigned_bam: an evidence BAM (--bamout) split by haplotype;
* filter_assigned_reads: the reads of an evidence BAM assigned to one
  haplotype.

The scripts that call variants take --device cuda|cpu (default cuda), as
the CLI does.
"""
