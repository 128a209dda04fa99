"""idle_in_program_ms.seek: stream idle ms a frame that began while the
host was inside one of the program's spans."""
from bench_h100.spans import idle_in_program_ms as read  # noqa: F401
