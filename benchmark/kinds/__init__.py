"""One module per traffic kind; a traffic file's `kind` names it."""
