"""scene_build_s: host seconds of the scene build in set-up: the
prototypes (or the OBJ file read by load_obj), build_composite_scene's k-d
tree and the first device scene (engine/wavefront.get_device_scene)."""


def read(run):
    s = run["setup"]
    return s["prototypes"] + s["kd_build"] + s["device_scene"]
