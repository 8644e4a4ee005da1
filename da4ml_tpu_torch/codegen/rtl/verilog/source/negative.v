// o = -a, sign/zero-extended to WO bits before negation (two's complement).
module negative #(
    parameter WA = 8,
    parameter SA = 1,
    parameter WO = 9
) (
    input  [WA-1:0] a,
    output [WO-1:0] o
);
    localparam WI = (WO > WA ? WO : WA) + 1;
    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] neg = -ea;
    assign o = neg[WO-1:0];
endmodule
