"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
harness's tests: the same configurations and traffic, with the scene's
arguments and the world count made small."""
from benchmark.harness import spec

SMALL_ARGS = {
    "full_frame": {"num_entities": 512, "num_characters": 8, "num_bodies": 32,
                   "particle_capacity": 256},
    "skinned_crowd": {"num_characters": 16, "animator_fraction": 0.5},
}
SEED = 2 ** 31 + 11


def small_cell(name: str, worlds: int = 3) -> spec.Cell:
    cell = spec.cell(name)
    cell.config = dict(cell.config, args=SMALL_ARGS[cell.config_name])
    cell.traffic = dict(cell.traffic, worlds=worlds)
    return cell
