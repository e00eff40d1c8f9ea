"""Typed pipeline configuration with preset profiles (the port's copy of
``t1k_tpu/config.py``).

One dataclass carries every knob of the three stages; presets mutate it
the same way run-t1k's flag macros do (run-t1k:289-314;
cli/run.py::resolve_preset goes through ``apply_preset``).  The resolved
config is serialized next to the outputs (<prefix>_config.json) for
provenance.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class PipelineConfig:
    # shared
    reference: str = ""
    threads: int = 1
    backend: str = "native"              # auto | native | gpu
    device: str = "cuda"                 # torch device of the gpu routes
    # extraction
    extractor_similarity: float = 0.8
    barcode_file: Optional[str] = None
    barcode_whitelist: Optional[str] = None
    barcode_range: Optional[tuple] = None
    read1_range: Optional[tuple] = None
    read2_range: Optional[tuple] = None
    # genotyping
    similarity: float = 0.8
    relax_intron_align: bool = False
    max_assign_cnt: int = 2000
    filter_frac: float = 0.15
    filter_cov: float = 1.0
    cross_gene_rate: float = 0.04
    min_squarem_alpha: float = 0.0
    allele_digit_units: int = -1
    allele_delimiter: str = ""
    allele_whitelist: Optional[str] = None
    # post analysis
    var_max_group: int = 8
    skip_post_analysis: bool = False
    # provenance
    preset: str = ""
    stage: int = 0

    def apply_preset(self, preset: str) -> "PipelineConfig":
        self.preset = preset
        if preset in ("hla", "hla-wgs"):
            self.similarity = 0.97
            if preset == "hla-wgs":
                self.extractor_similarity = 0.97
        elif preset == "kir-wgs":
            self.similarity = 0.9
            self.relax_intron_align = True
        elif preset == "kir-wes":
            self.relax_intron_align = True
        elif preset:
            raise ValueError(f"unknown preset {preset}")
        return self

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=list)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
