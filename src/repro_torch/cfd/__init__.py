"""simpleFoam on a structured grid (counterpart of ``repro.cfd``)."""
