"""PED pedigree file reading.

Capability-equivalent to the reference's pedigree reader
(src/io/pedigree/pedigree_reader.{hpp,cpp}) and Pedigree/Trio basics
(src/basics/pedigree.hpp, trio.hpp): parses 6-column PED files and resolves
trios (child with both parents present among the samples).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PedigreeMember:
    family: str
    name: str
    father: str | None
    mother: str | None
    sex: str            # 'male' | 'female' | 'unknown'


@dataclass(frozen=True)
class Trio:
    maternal: str
    paternal: str
    child: str


class Pedigree:
    def __init__(self, members: list[PedigreeMember]):
        self.members = {m.name: m for m in members}

    @staticmethod
    def read(path: str) -> "Pedigree":
        from ..errors import MalformedFileError, MissingFileError
        import os
        if not os.path.exists(path):
            raise MissingFileError(path, "pedigree (PED)",
                                   where="Pedigree.read",
                                   option="--pedigree")
        members = []
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split()
                if len(cols) < 4:
                    # pedigree_reader.cpp rejects rows without the
                    # family/sample/father/mother columns
                    raise MalformedFileError(
                        path, "pedigree (PED)",
                        detail=f"line {lineno} has {len(cols)} columns, "
                               "expected at least 4 "
                               "(family, sample, father, mother)",
                        where="Pedigree.read")
                fam, name, father, mother = cols[:4]
                sex = {"1": "male", "2": "female"}.get(
                    cols[4] if len(cols) > 4 else "0", "unknown")
                members.append(PedigreeMember(
                    fam, name,
                    None if father in ("0", ".") else father,
                    None if mother in ("0", ".") else mother,
                    sex))
        return Pedigree(members)

    def find_trio(self, samples: list[str]) -> Trio | None:
        """First trio whose three members are all in `samples`."""
        sset = set(samples)
        for m in self.members.values():
            if (m.name in sset and m.father in sset and m.mother in sset):
                return Trio(maternal=m.mother, paternal=m.father, child=m.name)
        return None


__all__ = ["Pedigree", "PedigreeMember", "Trio"]
