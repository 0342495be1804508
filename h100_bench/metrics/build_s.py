"""Host seconds in the program's builder (`entry.build*`)."""


def read(run):
    return run.build_s
