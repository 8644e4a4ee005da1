// MSB-select mux (DAIS opcode +/-6): sel = MSB of c (sign bit for signed,
// top data bit for unsigned — the same physical bit either way);
// o = sel ? wrap(a << SH0) : wrap((+/-b) << SH1).
module msb_mux #(
    parameter WC = 8,
    parameter WA = 8,
    parameter SA = 1,
    parameter WB = 8,
    parameter SB = 1,
    parameter NEG_B = 0,
    parameter SH0 = 0,
    parameter SH1 = 0,
    parameter WO = 8
) (
    input  [WC-1:0] c,
    input  [WA-1:0] a,
    input  [WB-1:0] b,
    output [WO-1:0] o
);
    localparam SHL0 = SH0 > 0 ? SH0 : 0;
    localparam SHR0 = SH0 < 0 ? -SH0 : 0;
    localparam SHL1 = SH1 > 0 ? SH1 : 0;
    localparam SHR1 = SH1 < 0 ? -SH1 : 0;
    localparam WI0 = (WA > WO + SHR0 ? WA : WO + SHR0) + SHL0 + 1;
    localparam WI1 = (WB > WO + SHR1 ? WB : WO + SHR1) + SHL1 + 2;

    wire signed [WI0-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI1-1:0] eb0 = SB ? $signed(b) : $signed({1'b0, b});
    wire signed [WI1-1:0] eb = NEG_B ? -eb0 : eb0;
    wire signed [WI0-1:0] r0 = (ea <<< SHL0) >>> SHR0;
    wire signed [WI1-1:0] r1 = (eb <<< SHL1) >>> SHR1;
    assign o = c[WC-1] ? r0[WO-1:0] : r1[WO-1:0];
endmodule
