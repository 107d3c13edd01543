"""Streaming FASTA/FASTQ reader, plain or gzip (reference
src/fastqloader.*).  Copy of graphchainer_tpu/io/fastq.py."""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class Read:
    name: str
    seq: str
    qual: Optional[str] = None


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def stream_reads(path: str) -> Iterator[Read]:
    with _open(path) as f:
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        if not line:
            return
        if line.startswith(">"):
            name = line[1:].strip().split()[0] if line.strip() != ">" else ""
            seq_parts = []
            for line in f:
                line = line.rstrip("\r\n")
                if line.startswith(">"):
                    if seq_parts or name:
                        yield Read(name=name, seq="".join(seq_parts).upper())
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    seq_parts = []
                elif line:
                    seq_parts.append(line)
            if seq_parts or name:
                yield Read(name=name, seq="".join(seq_parts).upper())
        elif line.startswith("@"):
            while line:
                name = line[1:].strip().split()[0]
                seq = f.readline().strip().upper()
                f.readline()  # '+'
                qual = f.readline().rstrip("\r\n")
                if seq:
                    yield Read(name=name, seq=seq, qual=qual or None)
                line = f.readline()
                while line and not line.strip():
                    line = f.readline()
        else:
            raise ValueError(f"unrecognized read file format: {path}")
