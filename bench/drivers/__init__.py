"""One driver a traffic kind: ``run(ctx)`` serves or trains one cell once."""
