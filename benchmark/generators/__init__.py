"""Traffic generators: each module here that defines ``pairs(seed,
params)`` is a generator a traffic file can name; ``hardsynth`` and
``modelnet`` are frozen copies of the program's scene generators."""
