"""Reimplementations of C-library ``srand``/``rand`` sub-seed derivation.

The reference derives three generator sub-seeds from the user seed via
``srand(seed); rand(); rand(); rand()`` (reference src/problem.cu:63-67).
Which C library answered those calls depends on how the binary was built:
the shipped batch files target MSVC (compile.bat, benchmark.bat) and the
shell script targets glibc (compile.sh). Both are small deterministic
generators, reimplemented here so seed-file instances are reproducible from
``(n, m, seed, min, max)`` exactly like the reference's
(problem.cu:49-67); the downstream uniform stream itself is Philox rather
than cuRAND (see generator.py — bit parity with cuRAND is impossible and
not required, SURVEY.md C3).
"""

from __future__ import annotations


def glibc_rand3(seed: int) -> tuple[int, int, int]:
    """First three outputs of glibc's TYPE_3 additive-feedback ``rand()``
    after ``srand(seed)``. Standard published algorithm."""
    seed = seed & 0xFFFFFFFF
    if seed == 0:
        seed = 1
    seq = [0] * 34
    seq[0] = seed
    for i in range(1, 31):
        # Schrage's method for (16807 * r) % 2147483647 without overflow.
        hi, lo = divmod(seq[i - 1], 127773)
        val = 16807 * lo - 2836 * hi
        if val < 0:
            val += 2147483647
        seq[i] = val
    for i in range(31, 34):
        seq[i] = seq[i - 31]
    for i in range(34, 344 + 3):
        seq.append((seq[i - 31] + seq[i - 3]) & 0xFFFFFFFF)
    return tuple(seq[i] >> 1 for i in range(344, 344 + 3))


def msvc_rand3(seed: int) -> tuple[int, int, int]:
    """First three outputs of MSVC's LCG ``rand()`` after ``srand(seed)``."""
    state = seed & 0xFFFFFFFF
    out = []
    for _ in range(3):
        state = (state * 214013 + 2531011) & 0xFFFFFFFF
        out.append((state >> 16) & 0x7FFF)
    return tuple(out)


def derive_subseeds(seed: int, flavor: str = "glibc") -> tuple[int, int, int]:
    """Three sub-seeds (b, c, A order as in problem.cu:63-67:
    seedOne -> b, seedTwo -> c, seedThree -> A)."""
    if flavor == "glibc":
        return glibc_rand3(seed)
    if flavor == "msvc":
        return msvc_rand3(seed)
    raise ValueError(f"unknown rand flavor {flavor!r}")
