"""entity_steps_per_s: W worlds x the world's entity slots x the frames the
window completed, over the window's seconds (first frame's start event to
the last frame's end event)."""


def read(run):
    w = run.window
    return run.worlds * run.scene.world.capacity * w.frames / w.seconds if w.seconds > 0 else None
