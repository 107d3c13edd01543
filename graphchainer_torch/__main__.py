from graphchainer_torch.cli import main

raise SystemExit(main())
