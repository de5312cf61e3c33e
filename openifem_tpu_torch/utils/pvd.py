"""ParaView .pvd collection writer (reference: source/utilities.cpp:38-81)."""

from __future__ import annotations


class PVDWriter:
    def __init__(self, time, filename: str):
        self.time = time
        self.filename = filename
        self.records = []  # (time, vtu filename)

    def write_current_timestep(self, prefix: str, n_digits: int = 6):
        name = f"{prefix}{self.time.get_timestep():0{n_digits}d}.vtu"
        self.records.append((self.time.current(), name))
        self._flush()

    def _flush(self):
        with open(self.filename, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="Collection" version="0.1" '
                    'ByteOrder="LittleEndian">\n  <Collection>\n')
            for t, name in self.records:
                f.write(f'    <DataSet timestep="{t}" group="" part="0" '
                        f'file="{name}"/>\n')
            f.write('  </Collection>\n</VTKFile>\n')
