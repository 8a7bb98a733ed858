"""Fail-stop poison of the port (the serving slice's part of
:mod:`repro.core.failstop`).

A fail-stop is a stream whose computation never returned. Recovery must
never read that stream, so tests, the chip smoke's poison check and the
unfused protected path overwrite its slot with :data:`GARBAGE` before
disentangling: any read of it would show in the result.
"""

# poison for lost streams (same value as the reference)
GARBAGE = -0x5A5A5A5A
