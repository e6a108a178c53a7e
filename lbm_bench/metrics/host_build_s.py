"""host_build_s: seconds of the program's host build (config, mesh, domain,
levels, statics with the kernel choice, force context)."""


def read(rec):
    return rec.host_build_s
